"""Frechet Inception Distance on the card.

Counterpart of palette_and_histo_gan_tpu/eval/fid.py: nearest-neighbour
resize, Inception preprocessing, the InceptionV3 forward
(models/inception.py), mean and covariance, and the distance, all on the
evaluator's device; the scipy formula of the reference is kept for parity.

The statistics and distances run in float64, which the card has (the JAX
package is float32 only because a TPU lacks float64; its float32 eigh path
carries an O(10) absolute floor at n = 44). The Inception forward runs in
float32 with TF32 off (`float32_exact`): under the reference's quirks the
inputs lie in [-1.008, -0.984] and the features are ~99.9% constant, so
TF32's ~1e-3 relative rounding swamps their sample-dependent part.

Reference quirks (`reference_quirks=True`, the default), as in the JAX
module: RGBA images in [-1, 1] go straight into resize + preprocess_input,
and the resize nearest-resamples the channel axis too (4 -> 3 channels
picks [0, 2, 3] = R, B, A). With `reference_quirks=False` the first three
channels are kept.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import float32_exact
from ..models import inception
from ..native import png_io

METHODS = ("auto", "lowrank", "eigh", "newton-schulz", "scipy")


# ---------------------------------------------------------------------------
# Resize + preprocess
# ---------------------------------------------------------------------------


def _nn_indices(out_size: int, in_size: int) -> torch.Tensor:
    """skimage resize(order=0) coordinates, floor((o + 0.5) * in/out),
    computed as JAX computes them: float32(o + 0.5) * float32(in / out)."""
    o = np.arange(out_size, dtype=np.float32) + np.float32(0.5)
    pos = np.floor(o * np.float32(in_size / out_size)).astype(np.int64)
    return torch.from_numpy(np.clip(pos, 0, in_size - 1))


def scale_images_nn(images: torch.Tensor, out_hw: int = 299,
                    reference_quirks: bool = True) -> torch.Tensor:
    """(N, H, W, C) -> (N, out, out, 3) nearest-neighbour resize. With
    reference_quirks the channel axis is nearest-resampled C -> 3 too."""
    _, h, w, c = images.shape
    iy = _nn_indices(out_hw, h).to(images.device)
    ix = _nn_indices(out_hw, w).to(images.device)
    out = images.index_select(1, iy).index_select(2, ix)
    if c == 3:
        return out
    if reference_quirks:
        return out.index_select(3, _nn_indices(3, c).to(images.device))
    return out[..., :3]


def preprocess_input(x: torch.Tensor) -> torch.Tensor:
    """keras inception_v3.preprocess_input (mode='tf'): x/127.5 - 1."""
    return x / 127.5 - 1.0


# ---------------------------------------------------------------------------
# Matrix square roots and distances
# ---------------------------------------------------------------------------


def sqrtm_newton_schulz(a: torch.Tensor, num_iters: int = 25) -> torch.Tensor:
    """Square root of a PSD matrix by the Newton-Schulz iteration, in a's
    dtype, normalized by the Frobenius norm; a numerically zero input has a
    zero root."""
    norm = torch.sqrt(torch.sum(a * a))
    if norm < 1e-30:
        return torch.zeros_like(a)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    y, z = a / norm, eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def _sqrtm_psd_eigh(a: torch.Tensor) -> torch.Tensor:
    """PSD square root by eigendecomposition, robust to the rank deficiency
    of covariances from fewer samples than features."""
    w, v = torch.linalg.eigh(a)
    return (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.T


def trace_sqrt_product(sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """Tr((sigma1 sigma2)^(1/2)) as Tr((S sigma2 S)^(1/2)), S = sigma1^(1/2),
    which keeps every matrix symmetric PSD."""
    s1 = _sqrtm_psd_eigh(sigma1)
    inner = s1 @ sigma2 @ s1
    w = torch.linalg.eigvalsh(0.5 * (inner + inner.T))
    return torch.sum(torch.sqrt(torch.clamp(w, min=0.0)))


def activation_statistics(acts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 mean and (rowvar=False, ddof=1) covariance, as numpy.cov
    (frechet_inception_distance.py:30-31)."""
    acts = acts.double()
    mu = acts.mean(dim=0)
    centered = acts - mu
    return mu, centered.T @ centered / (acts.shape[0] - 1)


def frechet_distance(mu1, sigma1, mu2, sigma2) -> torch.Tensor:
    """||mu1 - mu2||^2 + Tr(s1 + s2 - 2 (s1 s2)^(1/2))
    (frechet_inception_distance.py:33-41), in float64."""
    mu1, sigma1, mu2, sigma2 = (x.double() for x in (mu1, sigma1, mu2, sigma2))
    return (torch.sum((mu1 - mu2) ** 2) + torch.trace(sigma1) + torch.trace(sigma2)
            - 2.0 * trace_sqrt_product(sigma1, sigma2))


def frechet_distance_lowrank(acts1: torch.Tensor, acts2: torch.Tensor) -> torch.Tensor:
    """The exact FID straight from activations, in float64. With S_i =
    A_i^T A_i / (n_i - 1) (A_i centred), the nonzero eigenvalues of S_1 S_2
    are those of C C^T with C = A_1 A_2^T / sqrt((n_1 - 1)(n_2 - 1)), an
    (n_1, n_2) matrix, so Tr((S_1 S_2)^(1/2)) is C's nuclear norm: no
    2048x2048 decomposition at the reference's n = 44."""
    n1, n2 = acts1.shape[0], acts2.shape[0]
    a1, a2 = acts1.double(), acts2.double()
    mu1, mu2 = a1.mean(dim=0), a2.mean(dim=0)
    a1, a2 = a1 - mu1, a2 - mu2
    c = a1 @ a2.T / np.sqrt((n1 - 1) * (n2 - 1))
    return (torch.sum((mu1 - mu2) ** 2) + torch.sum(a1 * a1) / (n1 - 1)
            + torch.sum(a2 * a2) / (n2 - 1) - 2.0 * torch.sum(torch.linalg.svdvals(c)))


def _float64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def frechet_distance_scipy(mu1, sigma1, mu2, sigma2) -> float:
    """The reference's CPU formula with scipy's sqrtm, for parity."""
    from scipy.linalg import sqrtm

    mu1, sigma1, mu2, sigma2 = (_float64(x) for x in (mu1, sigma1, mu2, sigma2))
    covmean = sqrtm(sigma1.dot(sigma2))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(np.sum((mu1 - mu2) ** 2.0) + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def load_directory_of_images(path: str) -> np.ndarray:
    """Every file of a directory in sorted order, as (N, H, W, C) uint8 with
    the files' channels (3 for RGB PNGs, 4 for RGBA), as
    np.asarray(PIL.Image.open(f)) gives them (frechet_inception_distance.py:
    44-47). Decoded by the port's native decoder."""
    images = []
    for name in sorted(os.listdir(path)):
        file = os.path.join(path, name)
        h, w, colour = png_io.png_header(file)
        if colour not in (2, 6):
            raise ValueError(f"{file}: PNG colour type {colour}; FID reads RGB (2) and "
                             "RGBA (6) images")
        rgba = png_io.decode_png_rgba(file, h, w)
        if rgba is None:
            raise RuntimeError(f"the native PNG decoder could not read {file}")
        images.append(rgba if colour == 6 else rgba[..., :3])
    return np.stack(images)


# ---------------------------------------------------------------------------
# Public evaluator
# ---------------------------------------------------------------------------


class FidEvaluator:
    """FID between two image sets on one device:

        fid = FidEvaluator(device="cuda")
        value = fid.compare(real_images, fake_images)

    Images are (N, H, W, C) arrays or tensors (C = 3 or 4) or directories of
    PNGs. PHG_INCEPTION_WEIGHTS names converted pretrained weights
    (models/inception.py); unset, the weights are random.

    With `group` (parallel/mesh.py::DataGroup; every rank calls with the
    same images), batch_size is rounded up to a multiple of the world size,
    each rank forwards its rows of every chunk, and the activations are
    gathered in one all_reduce. They are per image, so their values do not
    change (JAX: FidEvaluator(mesh=))."""

    def __init__(self, batch_size: int = 11, reference_quirks: bool = True,
                 input_size: int = 299, device: torch.device | str = "cuda", group=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, but PyTorch sees no CUDA device")
        self.model = inception.load_params(input_size, self.device)
        self.group = group
        if group is not None:
            batch_size = -(-batch_size // group.world_size) * group.world_size
        self.batch_size = batch_size
        self.input_size = input_size
        self.reference_quirks = reference_quirks

    @torch.inference_mode()
    def activations(self, images) -> torch.Tensor:
        """(N, 2048) float32 pooled features, forwarded in chunks of
        batch_size; the last chunk is zero-padded and the padding dropped.
        Under a group each rank forwards its rows of every chunk."""
        images = torch.as_tensor(images).to(self.device)
        n, b = images.shape[0], self.batch_size
        rows = slice(None) if self.group is None else self.group.batch_slice(b)
        out = []
        with float32_exact():
            for i in range(0, n, b):
                chunk = images[i:i + b]
                if chunk.shape[0] < b:
                    chunk = torch.cat([chunk, chunk.new_zeros((b - chunk.shape[0],) + chunk.shape[1:])])
                scaled = scale_images_nn(chunk[rows].float(), self.input_size,
                                         self.reference_quirks)
                out.append(self.model(preprocess_input(scaled)))
        acts = torch.stack(out)  # (chunks, rows, 2048)
        if self.group is not None:
            acts = self.group.gather_rows(acts.transpose(0, 1), b).transpose(0, 1)
        return acts.reshape(-1, acts.shape[-1])[:n]

    def compare(self, images1, images2, method: str = "auto") -> float:
        """FID between two image sets (frechet_inception_distance.py:79-80).

        method: "auto", the low-rank path when either set has fewer images
        than features (always at the reference's 44), else "eigh";
        "lowrank"; "eigh" (alias "newton-schulz", as in the JAX module);
        "scipy", the reference's CPU formula."""
        if method not in METHODS:
            raise ValueError(f"unknown FID method {method!r}; one of {METHODS}")
        if isinstance(images1, (str, os.PathLike)):
            images1 = load_directory_of_images(images1)
        if isinstance(images2, (str, os.PathLike)):
            images2 = load_directory_of_images(images2)
        acts1, acts2 = self.activations(images1), self.activations(images2)
        if method == "auto":
            small = min(acts1.shape[0], acts2.shape[0]) < acts1.shape[1]
            method = "lowrank" if small else "eigh"
        if method == "lowrank":
            return float(frechet_distance_lowrank(acts1, acts2))
        mu1, s1 = activation_statistics(acts1)
        mu2, s2 = activation_statistics(acts2)
        if method == "scipy":
            return frechet_distance_scipy(mu1, s1, mu2, s2)
        return float(frechet_distance(mu1, s1, mu2, s2))
