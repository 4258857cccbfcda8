"""The ranks of the port's data-parallel tests (tests/test_torch_dist.py).

``main`` is what each spawned process runs: it joins a gloo group on the
CPU (``dist.init_group``) and runs a job's cases on its contiguous rows of
each global batch. ``run_cases`` with world 1 and no group is the
one-process reference on the whole batch. Imports no JAX.

A job is a dict saved with ``torch.save``: {"cases": {name: case}}, where
a case is
- {"kind": "steps", "spec": config, "state": a port ``state_dict()`` or
  None, "batch": (x_a, x_b, mask_a, mask_b) numpy global, "steps": [...]}:
  each step from the same start state, its metrics, the gradients each
  optimizer stepped with (after the group's mean) and the nets after it;
- {"kind": "fid", "spec": config, "gen": reference state dict path,
  "inception": .pth path, "moments": .npz path, "lists": (a, b),
  "batch": FID batch}: the in-training FID metric of the generator and
  the pools it was taken on.
"""

from __future__ import annotations

import numpy as np
import torch

from munit_tpu_torch.config import validate
from munit_tpu_torch.dist import mesh
from munit_tpu_torch.io.checkpoint import to_host


def rows(a: np.ndarray, rank: int, world: int) -> np.ndarray:
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def _nets(tr) -> dict:
    return {k: {n: t.detach().numpy().copy() for n, t in sd.items()}
            for k, sd in tr.state_dict()["nets"].items()}


def _to_float64(tr) -> None:
    """The trainer's nets and optimizer state in float64."""
    for net in tr._nets().values():
        net.double()
    for o in tr._opts().values():
        for f in ("mu", "nu", "params_copy"):
            setattr(o, f, {k: v.double() for k, v in getattr(o, f).items()})


def steps_case(case, rank: int, world: int) -> dict:
    from munit_tpu_torch.train.trainer import MUNITTrainer
    conf = validate(dict(case["spec"]))
    tr = MUNITTrainer(conf, "cpu")
    tr.init(torch.Generator().manual_seed(0))
    tr.seed_styles(3)
    if case.get("state") is not None:
        tr.load_state_dict(case["state"])
    dtype = getattr(torch, case.get("dtype", "float32"))
    if dtype == torch.float64:
        _to_float64(tr)
    start = to_host(tr.state_dict())
    x_a, x_b, m_a, m_b = (torch.from_numpy(rows(a, rank, world)).to(dtype)
                          for a in case["batch"])
    grads = {}
    update = tr._update

    def spy(g, name, params, extrapolate):
        update(g, name, params, extrapolate)     # means g over the group
        grads[name] = {k: v.detach().numpy().copy() for k, v in g.items()}
    tr._update = spy
    out = {"before": _nets(tr)}
    for step in case["steps"]:
        tr.load_state_dict(start)
        tr.iterations = 0
        grads.clear()
        if step == "dis":
            m = tr.dis_update(x_a, x_b)
        elif step == "gen":
            m = tr.gen_update(x_a, x_b, m_a, m_b)
        elif step == "dis_gen":
            m = tr.dis_gen_update(x_a, x_b, m_a, m_b)
        elif step == "classifier_sr":
            m = tr.domain_classifier_sr_update(
                x_a, x_b, domain_synth=False,
                lamb=conf["adaptation"]["dfeat_lambda"])
        else:
            raise ValueError(step)
        out[step] = {"metrics": {k: float(v) for k, v in m.items()},
                     "grads": dict(grads), "nets": _nets(tr)}
    return out


def fid_case(case, rank: int, world: int):
    from munit_tpu_torch.cli.translate import load_generator
    from munit_tpu_torch.data.api import get_fid_data_loader
    from munit_tpu_torch.eval import fid
    from munit_tpu_torch.eval.fid import guided_a2b, prepare_inception_metrics
    from munit_tpu_torch.eval.inception import load_inception

    class Sampler:
        device = torch.device("cpu")

        def __init__(self, gen):
            self.gen = gen

        def sample_fid(self, x_a, x_b):
            with torch.no_grad():
                return guided_a2b(self.gen, x_a, x_b)

    def recording(fn):
        def wrapped(*a, **k):
            pools.append(fn(*a, **k))
            return pools[-1]
        return wrapped

    conf = validate(dict(case["spec"]))
    gen = load_generator(case["gen"], conf, "cpu")
    loader = get_fid_data_loader(*case["lists"], case["batch"],
                                 new_size=conf["new_size"], num_workers=1)
    pools = []
    saved = fid.accumulate_activations
    fid.accumulate_activations = recording(saved)
    try:
        metric = prepare_inception_metrics(
            case["moments"], load_inception(case["inception"], "cpu"),
            newton_schulz=False, mesh=mesh.active())
        value = metric(Sampler(gen), loader)
    finally:
        fid.accumulate_activations = saved
    return value, pools[0]


def run_cases(job: dict, rank: int = 0, world: int = 1) -> dict:
    """The job's cases on one torch and one BLAS thread."""
    from threadpoolctl import threadpool_limits
    torch.set_num_threads(1)
    run = {"steps": steps_case, "fid": fid_case}
    with threadpool_limits(1):
        return {name: run[case["kind"]](case, rank, world)
                for name, case in job["cases"].items()}


def main(rank: int, world: int, port: int, job_path: str,
         out_dir: str) -> None:
    """A rank: join the group, run the job, save its results as
    ``<out_dir>/rank<rank>.pt``."""
    mesh.init_group(f"localhost:{port},{world},{rank}", "cpu")
    ok = False
    try:
        out = run_cases(torch.load(job_path, weights_only=False), rank,
                        world)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
        ok = True
    finally:
        mesh.shutdown(wait=ok)
