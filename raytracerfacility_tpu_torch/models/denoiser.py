"""CNN denoiser, inference: the OptiX AI denoiser's slot.

Port of the inference half of ``raytracerfacility_tpu/models/denoiser.py``:
``DenoiserUNet`` (a 3-scale U-Net over the 9 guide channels: demodulated
log irradiance, albedo, normal), ``compute_intensity``, ``_demodulate`` /
``_remodulate``, ``_albedo_guide``, ``_pad_to_multiple``, ``Denoiser``
(``load``, ``save``, ``denoise``, ``blend_factor``) and
``default_denoiser``. The reference feeds colour, albedo and normal to
``optixDenoiserInvoke`` and blends the result with the noisy input by
``(1 - strength) / frameId`` when accumulating (ref RayTracer.cu:494-557);
the blend is kept exactly.

Numerics follow the reference's flax modules (``dtype=bfloat16``,
``param_dtype=float32``): the network input, every kernel and bias are
cast to bfloat16, each convolution rounds to bfloat16 and its bias is
added in bfloat16, activations stay bfloat16 through ReLU, pooling and
the nearest 2x upsample, and the head's output is cast to float32. The
convolutions are ``torch.nn.functional.conv2d`` (cuDNN on the card).
Training is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_ALBEDO_EPS = 0.02
WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "denoiser_weights.npz")


class _Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), dtype=bfloat16)``: SAME padding,
    f32 parameters cast to bf16 at use, the bias added to the rounded
    bf16 convolution."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin, 3, 3), device="meta"))
        self.bias = nn.Parameter(torch.empty((cout,), device="meta"))

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(torch.bfloat16), padding=1)
        return y + self.bias.to(torch.bfloat16)[:, None, None]


class ConvBlock(nn.Module):
    """Two 3x3 convolutions, each followed by ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = _Conv(cin, features)
        self.conv1 = _Conv(features, features)

    def forward(self, x):
        return F.relu(self.conv1(F.relu(self.conv0(x))))


def _upsample2(x):
    """jax.image.resize(method="nearest") to exactly twice the height and
    width: each pixel repeated 2x2."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class DenoiserUNet(nn.Module):
    """3-scale U-Net: 9 input channels -> 3 output channels (the direct
    prediction in the demodulated domain). NCHW; H and W multiples of 4.
    Parameters are created on the meta device: load a state dict
    (``Denoiser.load_state_dict``) before use."""

    def __init__(self, base_features: int = 24):
        super().__init__()
        f = base_features
        self.enc0 = ConvBlock(9, f)
        self.enc1 = ConvBlock(f, 2 * f)
        self.enc2 = ConvBlock(2 * f, 4 * f)
        self.dec1 = ConvBlock(6 * f, 2 * f)
        self.dec0 = ConvBlock(3 * f, f)
        self.head = _Conv(f, 3)

    def forward(self, color, albedo, normal):
        x = torch.cat([color, albedo, normal], dim=1).to(torch.bfloat16)
        e0 = self.enc0(x)
        e1 = self.enc1(F.avg_pool2d(e0, 2))
        e2 = self.enc2(F.avg_pool2d(e1, 2))
        m1 = self.dec1(torch.cat([_upsample2(e2), e1], dim=1))
        m0 = self.dec0(torch.cat([_upsample2(m1), e0], dim=1))
        return self.head(m0).to(torch.float32)


def compute_intensity(color: torch.Tensor) -> torch.Tensor:
    """HDR exposure normalizer (the ``optixDenoiserComputeIntensity``
    analog, ref RayTracer.cu:523-531): k = 1 / exp(mean(log(luminance)))
    over the H and W axes of (..., H, W, C) colour, as a broadcastable
    (..., 1, 1, 1)."""
    lum = (0.2126 * color[..., 0] + 0.7152 * color[..., 1]
           + 0.0722 * color[..., 2])
    log_l = torch.log(torch.clamp(lum, min=1e-8))
    avg = torch.exp(torch.mean(log_l, dim=(-2, -1), keepdim=True))
    return (1.0 / torch.clamp(avg, 1e-4, 1e4))[..., None]


def _demodulate(color: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
    """log1p(max(color, 0) / max(albedo, eps)): the network's domain,
    approximately the surface irradiance."""
    return torch.log1p(torch.clamp(color, min=0.0)
                       / torch.clamp(albedo, min=_ALBEDO_EPS))


def _remodulate(pred: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_demodulate`; the prediction clamps to [0, 30]
    so a bf16 blow-up cannot overflow expm1."""
    return torch.expm1(torch.clamp(pred, 0.0, 30.0)) * torch.clamp(
        albedo, min=_ALBEDO_EPS)


def _albedo_guide(albedo: torch.Tensor) -> torch.Tensor:
    """The albedo guide input scaled into [0, 1] when it peaks above 1
    (HDR albedo AOVs); the demodulation divisor stays raw."""
    peak = torch.amax(albedo, dim=(-3, -2, -1), keepdim=True)
    return albedo / torch.clamp(peak, min=1.0)


def _pad_to_multiple(img: torch.Tensor, multiple: int = 4):
    """Edge-pad an (N, C, H, W) image at the bottom and right to H and W
    multiples of ``multiple``; returns (padded, (H, W))."""
    h, w = img.shape[-2], img.shape[-1]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        img = F.pad(img, (0, pw, 0, ph), mode="replicate")
    return img, (h, w)


class Denoiser:
    """Host-side wrapper of the denoiser lifecycle (create, load, invoke;
    ref RayTracer.cu:48-92, 508-556), on ``device``."""

    def __init__(self, base_features: int = 24, device="cuda"):
        self.base_features = base_features
        self.device = torch.device(device)
        self.model: DenoiserUNet | None = None

    @property
    def params(self) -> dict | None:
        """The network's state dict, or None before one is loaded."""
        return None if self.model is None else self.model.state_dict()

    def load_state_dict(self, state: dict) -> "Denoiser":
        """Take the parameters (names of :class:`DenoiserUNet`, OIHW
        kernels) onto the device."""
        model = DenoiserUNet(self.base_features).to_empty(device=self.device)
        model.load_state_dict(state)
        self.model = model.eval()
        return self

    def load(self, path: str) -> "Denoiser":
        """Load an npz checkpoint in the reference's layout ('/'-joined
        flax paths, HWIO kernels)."""
        from raytracerfacility_tpu_torch.convert import denoiser_state_dict_from_flax

        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return self.load_state_dict(denoiser_state_dict_from_flax(flat))

    def save(self, path: str) -> None:
        """Write the parameters as an npz in the reference's layout."""
        from raytracerfacility_tpu_torch.convert import denoiser_flax_from_state_dict

        if self.model is None:
            raise ValueError("no parameters to save: load a checkpoint first")
        np.savez_compressed(path, **denoiser_flax_from_state_dict(
            self.model.state_dict()))

    @torch.no_grad()
    def denoise(self, color: torch.Tensor, albedo: torch.Tensor,
                normal: torch.Tensor, blend_factor: float = 0.0) -> torch.Tensor:
        """Denoise one (H, W, >=3) image with the reference's blend:
        denoised * (1 - blend) + noisy * blend, as (H, W, 3) float32 on the
        image's device. The colour is exposure-normalized by the inverse
        average log-luminance before the network and de-normalized after
        (ref RayTracer.cu:523-531)."""
        if self.model is None:
            raise ValueError("no parameters: load a checkpoint first")
        for name, t in (("color", color), ("albedo", albedo), ("normal", normal)):
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the denoiser on "
                                 f"{self.device}")

        def nchw(t):
            return _pad_to_multiple(t.permute(0, 3, 1, 2))

        c = color[None, ..., :3]
        a = albedo[None, ..., :3]
        k = compute_intensity(c)
        c, (h, w) = nchw(_demodulate(c * k, a))
        a, _ = nchw(a)
        n, _ = nchw(normal[None, ..., :3])
        pred = self.model(c, _albedo_guide(a), n)
        out = _remodulate(pred, a)[0, :, :h, :w].permute(1, 2, 0) / k[0]
        blend = torch.tensor(blend_factor, dtype=torch.float32, device=self.device)
        return out * (1.0 - blend) + color[..., :3] * blend

    @staticmethod
    def blend_factor(strength: float, frame_id: int, accumulate: bool) -> float:
        """Ref RayTracer.cu:515-521."""
        if accumulate and frame_id > 1:
            return (1.0 - strength) / frame_id
        return 1.0 - strength


def default_denoiser(device="cuda") -> Denoiser | None:
    """The packaged pretrained denoiser on ``device`` (the port's copy of
    the reference's checkpoint), or None when no checkpoint ships (the
    camera then skips denoising)."""
    if not os.path.exists(WEIGHTS):
        return None
    return Denoiser(device=device).load(WEIGHTS)
