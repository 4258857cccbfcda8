"""Data parallel in the port (ROADMAP item 16) on the CPU, at the small
training spec (``torch_port_util.small_train_spec``: 32 px, the sim/real
classifier's fool term at adv_lambda 6 and its own step).

- Two gloo ranks (one ``torch.multiprocessing`` spawn, ``tests/
  torch_dist_worker.py``), each on its 4 rows of a global batch of 8,
  against one port process on the whole batch, every step from one state:
  the dis, gen, fused and classifier_sr steps, from JAX's initial state in
  float32 and, guided 1 and 0, from the port's seeded init in float64
  (``CASES``). Losses within rtol 1e-5, each optimizer's gradients within
  1e-4 of each leaf's largest (the conv biases that an instance norm or
  AdaIN removes, whose gradient is zero but for rounding, within 1e-4 of
  the net's largest), the classifiers' batch-norm running statistics
  within 1e-5 of each vector's largest; the two ranks' states equal bit
  for bit.
- The same ranks from the JAX trainer's state against its dis and fused
  steps under ``make_mesh()`` on the conftest's 8 fake devices (1 row a
  device): losses within rtol 1e-4, each update held to JAX's
  (``update_errors``).
- The group's in-training FID (each rank its slice of every FID batch,
  padded) against the one-process FID, within 1e-5 relative, and the
  gathered pools against the one-process pools (the real moments of one
  repeated image, sigma 0: scipy's 2048² ``sqrtm`` of a zero product is
  the cheapest there is).
- The loaders: ``--dist``'s shards and a ``--mesh`` worker's rows against
  the JAX package's ``DataLoader``, numpy only.
- ``train --dist localhost:<port>,2,<i> --device cpu`` as two processes:
  one ``metrics.jsonl`` line a step (the lead's), checkpoints, then
  ``--resume`` in two processes again.
- The switches: ``--spatial 2`` refused naming 16b, ``--mesh`` with one
  visible card is the plain run and with two starts two workers; the
  ``--dist`` spec; ``Replicas``' pad, split and gather; nothing changes
  outside a group.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import yaml
from PIL import Image

from munit_tpu.config import validate as jvalidate
from munit_tpu.data.loader import DataLoader as JLoader
from munit_tpu.dist import make_mesh, shard_batch
from munit_tpu.dist.mesh import replicate_state
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.cli import train as cli_train
from munit_tpu_torch.config import validate
from munit_tpu_torch.data.loader import DataLoader
from munit_tpu_torch.dist import mesh
from munit_tpu_torch.io import checkpoint
from munit_tpu_torch.nn.classifiers import BatchNorm
from munit_tpu_torch.train.trainer import MUNITTrainer
from tests import torch_dist_worker as worker
from tests.torch_port_util import (SMALL_GEN, check_update,  # noqa: F401
                                   inception_ref_weights, one_torch_thread,
                                   port_state, ref_layout_weights,
                                   save_torch, small_train_spec, train_batch,
                                   update_errors)

WORLD = 2
RANKS_TIMEOUT = 300
BATCH = 8            # global: 4 rows a rank, 1 a JAX device
LR = 1e-4
STEPS = ("dis", "gen", "dis_gen", "classifier_sr")
JAX_STEPS = ("dis", "dis_gen")
FID_PAIRS, FID_BATCH = 6, 3
# the cases of the two ranks against one process: from JAX's initial state
# in float32, and from the port's own seeded init in float64 (guided 1 and
# 0), where float32 rounding, which differs between a batch of 4 and one of
# 8, moves ReLU inputs across their kink and shifts some generator
# gradients by up to 1e-2 of their leaf's largest; float64 leaves the
# data-parallel math alone, equal to ~1e-15
CASES = ("jax", "guided1_f64", "guided0_f64")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _images(root, name, n, seed):
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = root / f"{name}{i}.png"
        Image.fromarray(rng.randint(0, 256, (40, 40, 3), np.uint8)).save(p)
        paths.append(str(p))
    (root / f"{name}.txt").write_text("\n".join(paths) + "\n")
    return str(root / f"{name}.txt")


def _fid_case(root):
    torch.save({"2": {k: torch.from_numpy(v) for k, v in
                      ref_layout_weights(SMALL_GEN, 4).items()}},
               root / "gen.pt")
    rng = np.random.RandomState(5)
    np.savez(root / "moments.npz", mu=rng.randn(2048).astype(np.float32),
             sigma=np.zeros((2048, 2048)))
    return {"kind": "fid", "spec": small_train_spec(),
            "gen": str(root / "gen.pt"),
            "inception": save_torch(inception_ref_weights(2),
                                    root / "incep.pth"),
            "moments": str(root / "moments.npz"),
            "lists": (_images(root, "fa", FID_PAIRS, 6),
                      _images(root, "fb", FID_PAIRS, 7)),
            "batch": FID_BATCH}


def _jax_mesh_steps(jtr, state, batch):
    """JAX's dis and fused steps under make_mesh(), each from ``state``:
    {kind: (metrics, state after)}."""
    m8 = make_mesh()
    out = {}
    x_a, x_b, m_a, m_b = batch
    with m8:
        jtr.frozen = replicate_state(m8, jtr.frozen)
        b = shard_batch(m8, {"x_a": x_a, "x_b": x_b, "m_a": m_a, "m_b": m_b})
        for kind in JAX_STEPS:
            jtr.state = replicate_state(m8, jax.tree.map(jnp.asarray, state))
            jtr.iterations = 0
            if kind == "dis":
                m = jtr.dis_update(b["x_a"], b["x_b"])
            else:
                m = jtr.dis_gen_update(b["x_a"], b["x_b"], b["m_a"], b["m_b"])
            out[kind] = ({k: float(v) for k, v in m.items()},
                         jax.tree.map(np.asarray, jtr.state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks (spawned first), the one-process reference and JAX's
    mesh steps beside them: {"ranks": [rank 0's, rank 1's], "one": ...,
    "jax": {kind: (metrics, state)}, "jax_start": JAX's state}."""
    root = tmp_path_factory.mktemp("dist")
    spec = small_train_spec(batch_size=BATCH)
    jtr = JTrainer(jvalidate(dict(spec)), jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, jtr.state)
    batch = train_batch(11, BATCH)
    steps = {"kind": "steps", "batch": batch, "steps": STEPS}
    job = {"cases": {
        "jax": {**steps, "spec": spec, "state": port_state(start, 0)},
        "guided1_f64": {**steps, "spec": spec, "state": None,
                        "dtype": "float64"},
        "guided0_f64": {**steps, "spec": small_train_spec(
            batch_size=BATCH, guided=0), "state": None, "dtype": "float64"},
        "fid": _fid_case(root)}}
    torch.save(job, root / "job.pt")
    ctx = mp.start_processes(worker.main, args=(
        WORLD, _free_port(), str(root / "job.pt"), str(root)),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        one = worker.run_cases(job)
        jax_steps = _jax_mesh_steps(jtr, start, batch)
    finally:
        deadline = time.monotonic() + RANKS_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                pytest.fail(f"the ranks ran past {RANKS_TIMEOUT} s")
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "one": one, "jax": jax_steps,
            "jax_start": start}


def _groups(nets):
    """A worker's nets as ``update_errors``' groups."""
    return {"gen": nets["gen"],
            "dis": {f"{d}.{k}": v for d in ("a", "b")
                    for k, v in nets[f"dis_{d}"].items()},
            "classifier": {f"{d}.{k}": v for d in ("a", "b")
                           for k, v in nets[f"classifier_sr_{d}"].items()}}


# ------------------------------------------------ two ranks, one process


def _removed_by_norm():
    """The generator's conv biases that an IN or AdaIN removes."""
    from munit_tpu_torch.nn.blocks import ConvBlock
    tr = MUNITTrainer(validate(small_train_spec()), "cpu")
    return {f"{n}.conv.bias" for n, m in tr.gen.module.named_modules()
            if isinstance(m, ConvBlock) and m.norm_type in ("in", "adain")}


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("case", CASES)
def test_group_step_equals_one_process(runs, case, step):
    got, want = runs["ranks"][0][case][step], runs["one"][case][step]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    assert set(got["grads"]) == set(want["grads"]) != set()
    removed = _removed_by_norm()
    for opt, leaves in want["grads"].items():
        largest = max(float(np.abs(g).max()) for g in leaves.values())
        for k, g in leaves.items():
            scale = (largest if opt == "gen" and k in removed
                     else float(np.abs(g).max()))
            assert np.abs(got["grads"][opt][k] - g).max() <= 1e-4 * scale, \
                (opt, k)


@pytest.mark.parametrize("case", CASES)
def test_batch_norm_statistics_are_the_global_batchs(runs, case):
    """The classifier step's running statistics: those of the whole batch,
    not of a rank's rows (a per-rank BN fails here)."""
    got = runs["ranks"][0][case]["classifier_sr"]["nets"]
    want = runs["one"][case]["classifier_sr"]["nets"]
    before = runs["one"][case]["before"]
    n = 0
    for net in ("classifier_sr_a", "classifier_sr_b"):
        for k, v in want[net].items():
            if "running" in k:
                assert not np.array_equal(v, before[net][k]), k
                assert np.abs(got[net][k] - v).max() <= \
                    1e-5 * np.abs(v).max(), k
                n += 1
    assert n == 2 * 2 * 6     # mean and var of 6 BNs a classifier


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_one_state(runs, case):
    a, b = (runs["ranks"][r][case] for r in range(WORLD))
    for step in STEPS:
        assert a[step]["metrics"] == b[step]["metrics"]
        for net, sd in a[step]["nets"].items():
            for k, v in sd.items():
                np.testing.assert_array_equal(b[step]["nets"][net][k], v,
                                              err_msg=f"{step} {net}.{k}")


# -------------------------------------------------------- JAX's mesh


@pytest.mark.parametrize("kind", JAX_STEPS)
def test_group_steps_match_jax_mesh(runs, kind):
    want_m, after = runs["jax"][kind]
    got = runs["ranks"][0]["jax"][kind]
    for k, v in want_m.items():
        if k.startswith("loss"):
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    before = _groups(runs["ranks"][0]["jax"]["before"])
    want = {n: {k: v.numpy() for k, v in d.items()}
            for n, d in _groups(port_state(after, 0)["nets"]).items()}
    errs = update_errors(before, want, _groups(got["nets"]), LR, {})
    updated = {"dis": {"dis"}, "dis_gen": {"dis", "gen"}}[kind]
    for net, e in errs.items():
        check_update(e, net in updated, (kind, net))


# -------------------------------------------------------------- FID


def test_group_fid_equals_one_process(runs):
    want_fid, want_pool = runs["one"]["fid"]
    assert np.isfinite(want_fid) and want_fid > 0
    assert want_pool.shape == (FID_PAIRS, 2048)
    for r in range(WORLD):
        fid, pool = runs["ranks"][r]["fid"]
        np.testing.assert_allclose(fid, want_fid, rtol=1e-5)
        assert np.abs(pool - want_pool).max() <= \
            1e-5 * np.abs(want_pool).max()


# ----------------------------------------------------------- loaders


class _Indexed:
    """A dataset whose sample i is i and a draw of its generator."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, rng):
        return {"image": np.array([i, rng.integers(1000)], np.int64)}


def _take(loader, n, start=0):
    it = loader.iter_from(start) if start else iter(loader)
    out = [next(it)["image"] for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("count", [2, 3])
def test_dist_shards_equal_jax(count):
    for index in range(count):
        kw = dict(shuffle=True, num_workers=2, seed=4, shard_index=index,
                  shard_count=count)
        want = _take(JLoader(_Indexed(23), 3, **kw), 5)
        got = _take(DataLoader(_Indexed(23), 3, **kw), 5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("count,start", [(2, 0), (4, 0), (2, 3)])
def test_mesh_rows_are_jax_batch_rows(count, start):
    """A --mesh worker's rows: its contiguous part of the JAX loader's
    global batch, on resume too."""
    want = _take(JLoader(_Indexed(19), 4, shuffle=True, num_workers=2,
                         seed=2), 6 + start)[start:]
    for index in range(count):
        loader = DataLoader(_Indexed(19), 4, shuffle=True, num_workers=2,
                            seed=2, row_index=index, row_count=count)
        per = 4 // count
        for g, w in zip(_take(loader, 6, start), want):
            np.testing.assert_array_equal(g, w[index * per:(index + 1) * per])


# --------------------------------------------------------- the CLI


def _write_data(root):
    rng = np.random.RandomState(3)
    keys = {}
    for dom in ("a", "b"):
        paths = []
        for i in range(8):
            p = root / f"{dom}{i}.jpg"
            Image.fromarray(rng.randint(0, 256, (40, 44, 3),
                                        np.uint8)).save(p)
            paths.append(str(p))
        (root / f"{dom}.txt").write_text("\n".join(paths) + "\n")
        keys.update({f"data_list_train_{dom}": str(root / f"{dom}.txt"),
                     f"data_list_test_{dom}": str(root / f"{dom}.txt"),
                     f"data_folder_train_{dom}": "/",
                     f"data_folder_test_{dom}": "/"})
    return keys


def _dist_train(cfg, out, *extra):
    """``train --dist`` as two processes; their outputs."""
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "munit_tpu_torch", "train", "--config",
         str(cfg), "--output_path", str(out), "--device", "cpu", "--dist",
         f"localhost:{port},{WORLD},{r}", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(WORLD)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return outs


def test_train_dist_cli_writes_once_and_resumes(tmp_path):
    spec = small_train_spec(**_write_data(tmp_path), precision="parity",
                            num_workers=1, log_iter=1, max_iter=2,
                            snapshot_save_iter=2, image_save_iter=2,
                            image_display_iter=1000, display_size=2)
    cfg = tmp_path / "dp.yaml"
    cfg.write_text(yaml.safe_dump(spec))
    first = _dist_train(cfg, tmp_path)
    cfg.write_text(yaml.safe_dump({**spec, "max_iter": 4}))
    resumed = _dist_train(cfg, tmp_path, "--resume")
    run = tmp_path / "outputs" / "dp"
    with open(run / "metrics.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    steps = [m["step"] for m in lines if "loss_dis_total" in m]
    assert steps == [1, 2, 3, 4]          # the lead's lines alone
    assert sum("parameters" in m for m in lines) == 2
    assert checkpoint.steps(str(run / "checkpoints")) == [2, 4]
    assert sorted(os.listdir(run / "images")) == sorted(
        f"gen_{d}_{k}_0000000{i}.jpg" for d in ("a2b", "b2a")
        for k in ("test", "train") for i in (2, 4))
    assert all("Resume from iteration 2" in o for o in resumed)
    assert "[1]" in first[0] and "[1]" not in first[1]
    _, step = checkpoint.restore_checkpoint(str(run / "checkpoints"))
    assert step == 4


def test_spatial_is_refused_naming_16b(tmp_path):
    with pytest.raises(SystemExit, match="16b"):
        cli_train.main(["--config", "c.yaml", "--spatial", "2",
                        "--device", "cpu"])


def test_mesh_without_dist(monkeypatch):
    """--mesh with one visible card is the plain run; with two it starts a
    worker a card."""
    calls = []
    monkeypatch.setattr(cli_train, "run",
                        lambda opts, rows=None: calls.append(("run", rows)))
    monkeypatch.setattr(cli_train, "spawn_mesh",
                        lambda argv, n: calls.append(("spawn", n)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    argv = ["--config", "c.yaml", "--mesh"]
    for cards in (1, 2):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        cli_train.main(argv)
    cli_train.main(argv + ["--device", "cpu"])
    assert calls == [("run", None), ("spawn", 2), ("run", None)]


def test_dist_spec(monkeypatch):
    parse = mesh.parse_spec
    assert parse("10.0.0.1:1234,4,3") == ("tcp://10.0.0.1:1234", 4, 3, 0)
    for bad in ("x,2", "host:1,2,2", ":1,2,0", "h:1,two,0"):
        with pytest.raises(SystemExit, match="expected"):
            parse(bad)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID",
              "SLURM_NTASKS", "SLURM_LOCALID", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="neither"):
        parse("auto")
    monkeypatch.setenv("SLURM_PROCID", "5")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    with pytest.raises(SystemExit, match="MASTER_ADDR"):
        parse("auto")
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert parse("auto") == ("tcp://node0:29500", 8, 5, 1)
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert parse("auto") == ("tcp://node0:29500", 4, 2, 2)


@pytest.mark.parametrize("n,k", [(7, 3), (8, 8), (3, 8), (5, 1)])
def test_replicas_pad_split_gather(n, k):
    """JAX's rule: pad by the last row to a multiple of the devices,
    contiguous parts, gathered and sliced back."""
    x = torch.arange(n * 2, dtype=torch.float32).reshape(n, 2)
    seen = []

    def fn(i, part):
        seen.append((i, part.clone()))
        return part * 2 + i * 0

    y = mesh.Replicas(["cpu"] * k)(fn, x)
    torch.testing.assert_close(y, x * 2, rtol=0, atol=0)
    padded = torch.cat([x, x[-1:].expand((-n) % k, 2)])
    assert [i for i, _ in seen] == list(range(k))
    torch.testing.assert_close(torch.cat([p for _, p in seen]), padded)


def test_outside_a_group_nothing_changes():
    """No group: the gradient mean does nothing, the batch norm and the
    style draw are the one-device code's."""
    assert not mesh.active() and mesh.world() == 1
    g = [torch.randn(3, 4)]
    before = g[0].clone()
    mesh.mean_over_group_(g)
    assert torch.equal(g[0], before)
    bn = BatchNorm(4)
    x = torch.randn(2, 3, 3, 4)
    mean = x.mean(dim=(0, 1, 2))
    var = (x - mean).square().mean(dim=(0, 1, 2))
    want = (x - mean) * torch.rsqrt(var + 1e-5)
    assert torch.equal(bn(x, False), want * bn.weight + bn.bias)
    tr = MUNITTrainer(validate(small_train_spec(guided=0)), "cpu")
    tr.seed_styles(9)
    got = tr.draw_style(2, torch.float32)
    assert torch.equal(got, torch.randn(
        (2, 8), generator=torch.Generator().manual_seed(9)))
