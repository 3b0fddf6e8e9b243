"""Classical 3x3 denoise stencils and the bilateral (counterpart of
`tpudenoise/denoise/stencils.py`), batched over (B, H, W, C) float32
images in the u8 domain.

* `gaussian_blur3`: cv2.GaussianBlur(3x3, 0), taps [1, 2, 1] / 4
  separable, BORDER_REFLECT_101, rounded floor(x + 0.5) (cv2's u8 path
  rounds half up);
* `mean3`: cv2.blur(3x3), the 3x3 sum times f32(1/9), rounded half to
  even;
* `median3`: cv2.medianBlur(3), BORDER_REPLICATE, Paeth's 19-exchange
  network;
* `bilateral`: cv2.bilateralFilter(d=9, 20, 100, BORDER_CONSTANT), through
  `denoise.bilateral.bilateral_batched` (the CUDA kernel on a GPU).

On u8-domain inputs every sum of the 3x3 filters is exact in f32, so the
results are bit-equal to the reference's whatever order XLA sums in.
"""

from __future__ import annotations

import torch

from tpudenoise_torch.denoise.bilateral import bilateral_batched


def _index(n: int, mode: str, device) -> torch.Tensor:
    """Rows -1 .. n of an axis of length n under a one-pixel border."""
    i = torch.arange(-1, n + 1, device=device)
    if mode == 'replicate':
        return i.clamp(0, n - 1)
    i = i.abs()                                    # reflect-101
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _pad1(img: torch.Tensor, mode: str) -> torch.Tensor:
    h, w = img.shape[1:3]
    return img[:, _index(h, mode, img.device)][:, :, _index(w, mode,
                                                            img.device)]


def _separable3(img: torch.Tensor, k0: float, k1: float) -> torch.Tensor:
    """The symmetric taps [k0, k1, k0] along H, then W, REFLECT_101."""
    p = _pad1(img, 'reflect')
    h = (k0 * p[:, :-2] + k1 * p[:, 1:-1]) + k0 * p[:, 2:]
    return (k0 * h[:, :, :-2] + k1 * h[:, :, 1:-1]) + k0 * h[:, :, 2:]


def gaussian_blur3(img: torch.Tensor, round_u8: bool = True) -> torch.Tensor:
    out = _separable3(img, 0.25, 0.5)
    return torch.floor(out + 0.5) if round_u8 else out


def mean3(img: torch.Tensor, round_u8: bool = True) -> torch.Tensor:
    out = _separable3(img, 1.0, 1.0) * (1.0 / 9.0)
    return torch.round(out) if round_u8 else out


# Paeth's 9-element median network: compare-exchange pairs in order
_PAETH = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
          (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
          (4, 2), (6, 4), (4, 2))


def median3(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[1:3]
    p = _pad1(img, 'replicate')
    v = [p[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    for i, j in _PAETH:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def bilateral(img: torch.Tensor) -> torch.Tensor:
    return bilateral_batched(img.to(torch.float32))
