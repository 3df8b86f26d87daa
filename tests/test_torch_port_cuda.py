"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skipped where there is none; imports no JAX, so that it runs on the
machine with the card:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m gpu -q

(``--noconftest``: the suite's conftest configures JAX.)
"""

import pytest
import torch

from srgan_tpu_torch.ops.patches import extract_patches, extract_patches_plain

N, H, W, P, B = 3, 80, 96, 32, 6

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="the CUDA kernels need a card and nvcc"),
]


def _inputs(dtype, channels):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.uint8:
        images = torch.randint(0, 256, (N, H, W, channels), generator=gen,
                               device=dev, dtype=torch.uint8)
    else:
        images = torch.randn((N, H, W, channels), generator=gen,
                             device=dev).to(dtype)
    indices = torch.randint(0, N, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    offsets = torch.stack(
        [torch.randint(0, H - P + 1, (B,), generator=gen, device=dev),
         torch.randint(0, W - P + 1, (B,), generator=gen, device=dev)],
        -1).to(torch.int32)
    offsets[0] = torch.tensor([0, 0])
    offsets[1] = torch.tensor([H - P, W - P])
    flips = torch.tensor([0, 1] * (B // 2), dtype=torch.int32, device=dev)
    return images, indices, offsets.contiguous(), flips


@pytest.mark.parametrize("dtype,channels,scale,shift", [
    (torch.uint8, 3, 2.0 / 255.0, -1.0),
    (torch.float32, 1, 1.0, 0.0),
    (torch.bfloat16, 1, 1.0, 0.0),
])
def test_patch_kernel_equals_plain(dtype, channels, scale, shift):
    images, indices, offsets, flips = _inputs(dtype, channels)
    before = extract_patches.launches
    got = extract_patches(images, offsets, flips, patch_size=P, scale=scale,
                          shift=shift, indices=indices)
    torch.cuda.synchronize()
    assert extract_patches.launches == before + 1
    want = extract_patches_plain(images, offsets, flips, patch_size=P,
                                 scale=scale, shift=shift, indices=indices)
    # Exact: the kernel rounds the multiply and the add separately.
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_patch_wrapper_rejects_what_the_kernel_does_not_take():
    images, indices, offsets, flips = _inputs(torch.uint8, 3)
    with pytest.raises(ValueError, match="int32"):
        extract_patches(images, offsets, flips, patch_size=P,
                        indices=indices.long())
    with pytest.raises(ValueError, match="contiguous"):
        extract_patches(images[:, :, ::2], offsets, flips, patch_size=P,
                        indices=indices)
    with pytest.raises(TypeError, match="dtype"):
        extract_patches(images.to(torch.int16), offsets, flips,
                        patch_size=P, indices=indices)
