"""Configuration (port of `low_precision_raytracer_tpu/config.py`).

Frozen dataclasses with the same field names and defaults as the JAX
package, cut to the fields the ported path reads.  `check_supported`
refuses, with `NotImplementedError`, every configuration this port does
not cover yet; it never approximates one.

`resolve_device` is the one place an entry point picks its device: CUDA
unless the caller asks for the CPU, and an error when no card is there.
It also pins float32 matmuls and convolutions to true f32 (no TF32): the
JAX package runs its f32 math at `highest` precision.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Precision:
    """A low-precision rendering policy: per-op rounding units of the
    dtype triangle test and the self-intersection offsets."""

    name: str
    delta1: float
    delta2: float
    ray_moveforward_t: float = 1e-4
    # for launches whose origins ride exactly (f32 hit positions): only
    # the intersection test's own t error needs clearing
    ray_moveforward_t_exact: float = 1e-4

    @property
    def dtype(self) -> torch.dtype:
        return {"fp32": torch.float32, "bf16": torch.bfloat16,
                "fp16": torch.float16}[self.name]

    @property
    def is_f32(self) -> bool:
        return self.name == "fp32"


FP32 = Precision("fp32", delta1=2.0**-10, delta2=2.0**-8, ray_moveforward_t=1e-4)
FP16 = Precision("fp16", delta1=2.0**-10, delta2=2.0**-8, ray_moveforward_t=1e-1,
                 ray_moveforward_t_exact=1e-2)
BF16 = Precision("bf16", delta1=2.0**-7, delta2=2.0**-5, ray_moveforward_t=1e-1,
                 ray_moveforward_t_exact=1e-2)

_PRECISIONS = {"fp32": FP32, "fp16": FP16, "bf16": BF16}


def get_precision(name: str | Precision) -> Precision:
    if isinstance(name, Precision):
        return name
    return _PRECISIONS[name]


@dataclass(frozen=True)
class SVGFConfig:
    """SVGF denoiser constants."""

    sigma_z: float = 1.0
    sigma_n: float = 128.0
    sigma_l: float = 4.0
    eps: float = 1e-5
    # a-trous strides; iteration #1's output is next frame's colour history
    strides: tuple[int, ...] = (1, 2, 4, 8, 16)
    color_mix_weight: float = 0.1
    moments_mix_weight: float = 0.1
    # frames below this use the spatial (bilateral) moments estimate
    spatial_moments_below: int = 4
    # carried temporal state in f32 (False: in the render dtype; the
    # kernels compute in f32 either way)
    state_f32: bool = True


@dataclass(frozen=True)
class DemoSettings:
    """Per-term display toggles."""

    add_direct_out: bool = True
    add_gi_colored: bool = True
    add_gi_white: bool = True
    demodulate: bool = False
    svgf: bool = True


@dataclass(frozen=True)
class RenderConfig:
    """The renderer configuration (fields the ported path reads)."""

    width: int = 1024
    height: int = 768
    precision: str = "fp32"

    gi_on: bool = True
    # a first-round shade plus one GI bounce
    max_bounces: int = 2
    max_direct_lights: int = 4

    svgf: SVGFConfig = SVGFConfig()
    demo: DemoSettings = DemoSettings()
    taa_mix_weight: float = 1.0
    taa_on: bool = True
    # run the TAA half even at mix weight 1, where the renderer elides it
    # as the identity (a test hook: elided and full frames are bitwise equal)
    taa_force_full: bool = False
    # shading computes in f32 even in bf16 / fp16 mode (False: the dtype
    # shader, in the render dtype)
    shade_f32: bool = True
    # 'auto' resolves to 'mxu3' (f32-grade u/v, strict acceptance) for
    # bf16 and fp16, and to 'both' for fp32.  'both': the dtype test with
    # an error band, lanes inside the band re-tested in f32 (fp32: the
    # strict test inside the band); 'dtype': the band-widened dtype test
    triangle_fallback: str = "auto"
    # 'auto' resolves per scene as the JAX package does on the TPU: the
    # dense route ('dense_pallas') up to packet_bvh_min_tris instance
    # triangles, the packet BVH ('pallas') up to packet_bvh_max_tris, the
    # two-level BVH walk ('jax', ops/traversal.py) above; 'dense' is the
    # all-pairs route (ops/dense.py), taken only when named
    traversal_impl: str = "auto"
    packet_bvh_min_tris: int = 1 << 20
    packet_bvh_max_tris: int = 4 << 20
    # incoherent launches (GI bounces, bounce shadows) on multi-chunk
    # scenes of the dense route: 'anchor' sorts rays by their nearest
    # chunk's entry bound + direction bits before the trace, 'beam' /
    # 'origin' by a morton code of origin and direction / origin; 'none'
    # keeps pixel order
    incoherent_sort: str = "anchor"
    # 'wavefront' sends incoherent launches above wavefront_min_tris to
    # the per-ray wavefront; 'tile' never does
    incoherent_impl: str = "wavefront"
    wavefront_min_tris: int = 16384
    # the wavefront's scheduling form: 'auto' resolves to 'oneshot' (every
    # (ray, candidate) pair one lane); 'rounds': rank-major rounds of
    # Q_RANKS candidates per lane (ops/wavefront.py)
    wavefront_mode: str = "auto"
    # fused in-kernel shadow phase on single-chunk scenes
    di_fuse: str = "auto"
    # dense chunk epilogue: 'auto' = 'reduce5' (exact winner); 'pack' (bf16
    # and fp16 closest hit; fp32 ignores it) picks each chunk's winner by a
    # packed (t bits | row) key and quantizes u/v to 2^-14
    dense_epilogue: str = "auto"
    # multi-device mesh (JAX: jax.sharding.Mesh); not ported
    mesh: object = None

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.max_bounces < 1:
            raise ValueError("max_bounces counts the primary shade round")
        for name, allowed in (("triangle_fallback", ("auto", "both", "dtype", "mxu3")),
                              ("traversal_impl", ("auto", "dense_pallas", "pallas", "jax",
                                                  "dense")),
                              ("incoherent_sort", ("anchor", "beam", "origin", "none")),
                              ("incoherent_impl", ("tile", "wavefront")),
                              ("wavefront_mode", ("auto", "rounds", "oneshot")),
                              ("di_fuse", ("auto", "off")),
                              ("dense_epilogue", ("auto", "reduce5", "pack"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r} not in {allowed}")

    @property
    def prec(self) -> Precision:
        return get_precision(self.precision)


# Skybox ambient colour used by the NO_GI fake-ambient path (all zero)
SKYBOX_COLOR = (0.0, 0.0, 0.0)


def check_supported(cfg: RenderConfig) -> None:
    """Raise NotImplementedError for configurations the port does not
    cover yet; each message names the ROADMAP queue-1 item that adds it."""
    if cfg.mesh is not None:
        raise NotImplementedError(
            "cfg.mesh: multiple GPUs wait (ROADMAP queue 1 item 10)")


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller passes a device; raises when CUDA is asked
    for (explicitly or by default) and no card is present.  Also turns
    TF32 off for f32 matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev
