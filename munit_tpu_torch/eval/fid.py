"""FID: the port's counterpart of ``munit_tpu/eval/fid.py`` (reference
inception_utils.py:90-308).

``sqrt_newton_schulz`` is the matrix square root by 400 Newton-Schulz
iterations in float32, its matmuls with TF32 off (the JAX package's
``Precision.HIGHEST`` matmuls), on the device of its input. A strongly
rank-deficient covariance product (far fewer images than 2048) makes it
diverge; ``compute_fid_from_pools`` then falls back to the exact scipy
``sqrtm`` with eps jitter on the host, as the JAX package and the reference
(inception_utils.py:145-203) do.

``prepare_inception_metrics`` gives the loop its in-training FID
(``eval_fid``): guided a→b translations of the FID loader's pairs
(``trainer.sample_fid``), their pool-3 activations, and the Fréchet
distance to the precomputed real moments (``cli/compute_moments``). In a
data-parallel group (``mesh=True``) every rank reads the whole FID list,
translates and pools its contiguous slice of each batch (padded to a
multiple of the ranks by repeating its last row), and the pools are
gathered in rank order: the one-process FID (``munit_tpu/eval/fid.py:
108-160``).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from munit_tpu_torch.core.ops import exact_f32
from munit_tpu_torch.dist import mesh as dist
from munit_tpu_torch.eval.inception import pool_and_logits


def sqrt_newton_schulz(a: torch.Tensor, num_iters: int = 400) -> torch.Tensor:
    """Matrix square root of a (D, D) symmetric PSD-ish matrix by
    Newton-Schulz (inception_utils.py:125-140; 400 iterations at the call
    site :234), float32 throughout."""
    with exact_f32():
        a = a.float()
        norm_a = torch.sqrt(torch.sum(a * a))
        y = a / norm_a
        eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
        z = eye
        for _ in range(num_iters):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
        return y * torch.sqrt(norm_a)


def cov(pool: torch.Tensor) -> torch.Tensor:
    """Sample covariance over rows (torch_cov rowvar=False semantics)."""
    with exact_f32():
        m = pool - pool.mean(dim=0, keepdim=True)
        return (m.T @ m) / (pool.shape[0] - 1)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def frechet_distance(mu1, sigma1, mu2, sigma2, num_iters: int = 400,
                     device=None) -> float:
    """FID through the Newton-Schulz square root of sigma1·sigma2
    (torch_calculate_frechet_distance, inception_utils.py:206-241), every
    operand in float32 on ``device`` (that of ``sigma1`` when None)."""
    if device is None:
        device = sigma1.device if torch.is_tensor(sigma1) else "cpu"
    mu1, mu2 = _f32(mu1, device), _f32(mu2, device)
    sigma1, sigma2 = _f32(sigma1, device), _f32(sigma2, device)
    with exact_f32():
        diff = mu1 - mu2
        covmean = sqrt_newton_schulz(sigma1 @ sigma2, num_iters)
        out = (diff @ diff + torch.trace(sigma1) + torch.trace(sigma2)
               - 2.0 * torch.trace(covmean))
    return float(out)


def frechet_distance_scipy(mu1, sigma1, mu2, sigma2,
                           eps: float = 1e-6) -> float:
    """Exact scipy-sqrtm FID (numpy_calculate_frechet_distance,
    inception_utils.py:145-203) with the same eps-jitter fallback."""
    from scipy import linalg
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    def _sqrtm(a):
        out = linalg.sqrtm(a)
        return out[0] if isinstance(out, tuple) else out

    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_fid_from_pools(pool_fake, mu_real, sigma_real,
                           newton_schulz: bool = True, device=None) -> float:
    """FID of the fake pools (N, 2048) against real moments. The fakes'
    mean and covariance are float32 on ``device`` (the pool's when None);
    with ``newton_schulz`` the distance is taken there by Newton-Schulz,
    and by scipy's ``sqrtm`` on the host when that is not finite or when
    ``newton_schulz`` is False."""
    if device is None:
        device = pool_fake.device if torch.is_tensor(pool_fake) else "cpu"
    pool = _f32(pool_fake, device)
    mu = pool.mean(dim=0)
    sigma = cov(pool)
    if newton_schulz:
        fid = frechet_distance(mu, sigma, mu_real, sigma_real, device=device)
        if np.isfinite(fid):
            return fid
    return frechet_distance_scipy(mu.cpu().numpy(), sigma.cpu().numpy(),
                                  np.asarray(mu_real), np.asarray(sigma_real))


def guided_a2b(gen, x_a: torch.Tensor, x_b: torch.Tensor) -> torch.Tensor:
    """``sample_fid``'s translation (trainer.py:1087-1131, batched): a's
    content decoded with b's style into domain b."""
    return gen.decode(gen.encode_content(x_a, 1), gen.encode_style(x_b, 2), 2)


@torch.no_grad()
def accumulate_activations(split, pool_fn: Callable,
                           fid_batches: Iterable) -> np.ndarray:
    """accumulate_inception_activations (inception_utils.py:246-254):
    ``pool_fn(i, x_a, x_b)``, device i's pools of the translations of its
    part of a paired batch, over each batch as ``split`` parts it
    (``dist.Replicas``: a part a device of this process, or
    ``dist.GroupSlice``: this rank's part of the group's), concatenated."""
    return np.concatenate(
        [split(pool_fn, torch.from_numpy(b["image_a"]),
               torch.from_numpy(b["image_b"])).cpu().numpy()
         for b in fid_batches], axis=0)


def prepare_inception_metrics(inception_moment_path: str, inception,
                              newton_schulz: bool = True,
                              mesh: bool = False) -> Callable:
    """The reference protocol (inception_utils.py:258-308): returns
    ``get_inception_metrics(trainer, fid_loader)`` → FID, with
    ``inception`` an ``InceptionV3`` on the trainer's device.
    ``newton_schulz=False`` takes scipy's exact ``sqrtm`` (the JAX package's
    ``use_jax=False``, cheaper than 400 iterations on a CPU host).
    ``mesh``: over the data-parallel group this process is in (every rank
    calls it and gets the FID, which the lead computes from the gathered
    pools)."""
    if mesh and not dist.active():
        raise ValueError("mesh=True needs a data-parallel group "
                         "(dist.init_group)")
    with np.load(inception_moment_path) as moments:
        data_mu, data_sigma = moments["mu"], moments["sigma"]

    def pool_fn(img_pm1):
        return pool_and_logits(inception, img_pm1)[0]

    def get_inception_metrics(trainer, fid_loader,
                              newton_schulz=newton_schulz):
        split = (dist.GroupSlice(trainer.device) if mesh
                 else dist.Replicas([trainer.device]))
        pool = accumulate_activations(
            split, lambda i, x_a, x_b: pool_fn(trainer.sample_fid(x_a, x_b)),
            fid_loader.batches())
        if mesh and not dist.is_lead():
            return dist.from_lead(0.0)
        fid = compute_fid_from_pools(pool, data_mu, data_sigma,
                                     newton_schulz, device=trainer.device)
        return dist.from_lead(fid) if mesh else fid

    return get_inception_metrics
