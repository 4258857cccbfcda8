"""munit_tpu_torch: the PyTorch / CUDA port of munit_tpu for NVIDIA Hopper.

It imports torch, never jax, and nothing of ``munit_tpu``; the JAX package
is the reference its tests hold it against. Layout and names follow the JAX
package. Tensors at public functions are NHWC, as there.
"""
