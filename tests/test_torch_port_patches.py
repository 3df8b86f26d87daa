"""The port's patch sampler against the JAX package's Pallas kernel (run in
interpret mode on the CPU) and the NumPy golden model. The CUDA kernel's
own test is ``test_torch_port_cuda.py``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from srgan_tpu.ops.patches import extract_patches as jax_extract_patches
from srgan_tpu_torch.ops.patches import (extract_patches,
                                         extract_patches_plain,
                                         extract_patches_reference,
                                         sampler_plan)

N, H, W, P, B = 3, 80, 96, 32, 6


def _inputs(dtype: str, channels: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        images = rng.integers(0, 256, (N, H, W, channels), dtype=np.uint8)
    else:
        images = rng.normal(0, 1, (N, H, W, channels)).astype(np.float32)
        if dtype == "bfloat16":
            images = images.astype(ml_dtypes.bfloat16)
    indices = rng.integers(0, N, B).astype(np.int32)
    offsets = np.stack([rng.integers(0, H - P + 1, B),
                        rng.integers(0, W - P + 1, B)], -1).astype(np.int32)
    offsets[0] = (0, 0)
    offsets[1] = (H - P, W - P)
    flips = np.array([0, 1] * (B // 2), np.int32)
    return images, indices, offsets, flips


def _torch_images(images: np.ndarray) -> torch.Tensor:
    if images.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(images.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(images)


CASES = [  # (dtype, channels, scale, shift): images and the two label dtypes
    ("uint8", 3, 2.0 / 255.0, -1.0),
    ("float32", 1, 1.0, 0.0),
    ("bfloat16", 1, 1.0, 0.0),
]


@pytest.mark.parametrize("dtype,channels,scale,shift", CASES)
def test_plain_equals_jax_kernel_and_reference(dtype, channels, scale,
                                               shift):
    images, indices, offsets, flips = _inputs(dtype, channels)
    want = np.asarray(jax_extract_patches(
        jnp.asarray(images), jnp.asarray(offsets), jnp.asarray(flips),
        patch_size=P, scale=scale, shift=shift,
        indices=jnp.asarray(indices)))
    ref = extract_patches_reference(images, offsets, flips, P, scale, shift,
                                    indices)
    args = (_torch_images(images), torch.from_numpy(offsets),
            torch.from_numpy(flips))
    plain = extract_patches_plain(*args, patch_size=P, scale=scale,
                                  shift=shift,
                                  indices=torch.from_numpy(indices)).numpy()
    # The wrapper takes the plain version for CPU tensors.
    wrapped = extract_patches(*args, patch_size=P, scale=scale, shift=shift,
                              indices=torch.from_numpy(indices)).numpy()
    assert plain.shape == (B, P, P, channels) and plain.dtype == np.float32
    np.testing.assert_array_equal(plain, ref)
    # XLA on the CPU contracts x * scale + shift into one FMA, so JAX's
    # kernel can differ from its own golden model by one rounding: at most
    # one ulp of values in [-1, 1], 2**-23. Labels (scale 1, shift 0) are
    # exact either way.
    atol = 2.0 ** -23 if (scale, shift) != (1.0, 0.0) else 0.0
    np.testing.assert_allclose(plain, want, rtol=0, atol=atol)
    np.testing.assert_array_equal(wrapped, plain)


def test_default_indices_and_bounds():
    images, _, offsets, flips = _inputs("float32", 1)
    out = extract_patches_plain(torch.from_numpy(images),
                                torch.from_numpy(offsets[:N]),
                                torch.from_numpy(flips[:N]), patch_size=P)
    np.testing.assert_array_equal(
        out.numpy(), extract_patches_reference(images, offsets[:N],
                                               flips[:N], P))
    bad = offsets[:N].copy()
    bad[0, 1] = W - P + 1
    with pytest.raises(ValueError, match="out of bounds"):
        extract_patches_plain(torch.from_numpy(images), torch.from_numpy(bad),
                              torch.from_numpy(flips[:N]), patch_size=P)


def test_wrapper_on_cpu_launches_no_kernel():
    images, indices, offsets, flips = _inputs("uint8", 3)
    before = extract_patches.launches
    extract_patches(torch.from_numpy(images), torch.from_numpy(offsets),
                    torch.from_numpy(flips), patch_size=P,
                    indices=torch.from_numpy(indices))
    assert extract_patches.launches == before


# The launch plan (``sampler_plan``) at the flagship's calls (the image and
# label calls of a step, the validation's 96 grid patches), at the tests'
# shapes, at rows that are not whole 16-byte vectors (W = 97; P = 30), and
# at batches of 1 and 300: (B, H, W, C, P, itemsize).
PLAN_SHAPES = [(120, 384, 512, 3, 224, 1), (120, 384, 512, 1, 224, 4),
               (96, 384, 512, 3, 224, 1), (B, H, W, 3, P, 1),
               (B, H, W, 1, P, 4), (B, H, W, 1, P, 2), (B, H, 97, 3, P, 1),
               (B, H, W, 1, 30, 1), (1, H, W, 3, P, 1),
               (300, H, 97, 3, 30, 2)]
SMEM_LIMIT = 227 * 1024  # what a block of the H100 may take


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_sampler_plan_tiles_every_row_once(shape):
    b, h, w, c, p, itemsize = shape
    plan = sampler_plan(*shape)
    rows = plan.tile_rows
    covered = np.zeros(p, int)
    for tile in range(-(-p // rows)):  # the kernel's grid.x
        covered[tile * rows:min(tile * rows + rows, p)] += 1
    np.testing.assert_array_equal(covered, 1)
    # Each block stages its tile's rows of P·C elements, each from any
    # byte of a 16-byte vector.
    assert plan.staged_rows == rows
    assert plan.smem_bytes == rows * (-(-(p * c * itemsize + 15) // 16) * 16)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    if p == 224:  # the flagship's calls fill the 132 SMs twice over
        assert rows > 1 and b * -(-p // rows) >= 16 * 132


@pytest.mark.parametrize("shape,match", [
    ((B, H, W, 3, 81, 1), "does not fit"),
    ((B, H, W, 3, 0, 1), "does not fit"),
    ((1, 20000, 20000, 3, 20000, 4), "exceeds the kernel's 232448 bytes"),
    ((65536, H, W, 3, P, 1), "at most 65535 examples"),
])
def test_sampler_plan_refuses_what_the_kernel_does_not_take(shape, match):
    """The plan raises the wrapper's error (the wrapper calls it before a
    launch)."""
    with pytest.raises(ValueError, match=match):
        sampler_plan(*shape)
