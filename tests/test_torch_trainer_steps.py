"""A short training trajectory of the port (munit_tpu_torch.train.trainer)
against the JAX package's ``MUNITTrainer``, in bench.py's cadence.

Small widths, 32 px, batch 2, masked cycle loss, ``adv_lambda: 6``,
``dfeat_lambda: 1``, ``semantic_w: 0``, Adam with weight decay,
``ratio_disc_gen: 2`` and ``classif_frequency: 2``: iteration 0 is a dis
step, iteration 1 the fused dis+gen step and the ``classifier_sr`` step,
iteration 2 a dis step. Both start from the JAX trainer's seeded state.

Every loss of every step agrees within rtol 1e-4 (float32 sums in another
order). Adam divides each update by sqrt(v): on a weight whose gradient is
near 0, rounding can flip the update's sign, so the parameters are bounded
at 2 lr per update of their net. The classifiers' running statistics agree
within rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from munit_tpu.config import validate as jvalidate
from munit_tpu.train import MUNITTrainer as JTrainer
from munit_tpu_torch.config import validate
from munit_tpu_torch.train.trainer import MUNITTrainer, train_steps
from tests.torch_port_util import (jax_net_params, jax_steps,  # noqa: F401
                                   load_jax_state, one_torch_thread,
                                   small_train_spec, train_batch)

ITERS = 3
LR = 1e-4


@pytest.fixture(scope="module")
def trajectories():
    spec = small_train_spec()
    assert spec["optimizer"] == "adam"
    jtr = JTrainer(jvalidate(spec), jax.random.PRNGKey(0))
    tr = MUNITTrainer(validate(spec), "cpu")
    load_jax_state(tr, jtr.state)
    batch = train_batch(2)
    want = jax_steps(jtr, map(jnp.asarray, batch), ITERS)
    got = train_steps(tr, *map(torch.from_numpy, batch), range(ITERS))
    return want, [{k: float(v) for k, v in m.items()} for m in got], \
        jax_net_params(jtr.state), tr


def test_losses_match_jax_at_every_step(trajectories):
    want, got, _, _ = trajectories
    assert [sorted(m) for m in got] == [
        sorted(k for k in w if k in m) for w, m in zip(want, got)]
    assert "loss_gen_total" in got[1] and "loss_classifier_sr" in got[1]
    for it, (w, g) in enumerate(zip(want, got)):
        for k, v in g.items():
            np.testing.assert_allclose(v, w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} it={it}")


@pytest.mark.parametrize("net,updates", [("gen", 1), ("dis", ITERS),
                                         ("classifier", 1)])
def test_parameters_match_jax_after_the_steps(trajectories, net, updates):
    _, _, want, tr = trajectories
    if net == "gen":
        got = tr.gen.state_dict()
    elif net == "dis":
        got = {f"{d}.{k}": v for d in ("a", "b")
               for k, v in getattr(tr, f"dis_{d}").state_dict().items()}
    else:
        got = {f"{d}.{k}": v for d in ("a", "b") for k, v in
               getattr(tr, f"classifier_sr_{d}").state_dict().items()}
    assert set(got) == set(want[net])
    for k, w in want[net].items():
        g = got[k].detach().numpy()
        if "running" in k:       # batch statistics: no optimizer in between
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR * updates,
                                       err_msg=k)
