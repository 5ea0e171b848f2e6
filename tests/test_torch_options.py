"""PyTorch port, the last render options (`shade_f32=False`,
`state_f32=False`, a non-integer `sigma_n`, a-trous strides above 16): each
against the JAX `Renderer` over 4 frames of the flagship Cornell box in
bf16 at 32 x 32, the port fed the JAX package's draws (the GI uniforms in
the shade dtype, the TAA bits).  The JAX side runs the TPU route (dense
Pallas trace, Pallas SVGF, in interpret mode), and for strides above 16
its XLA denoiser (`wavelet_impl='xla'`): the Pallas chain asserts
`2 * stride <= PAD` (`ops/svgf_pallas.py:477-481`).  `state_f32=False` runs
at TAA 0.3, where the history the JAX package holds in bf16 is read.

This file holds `shade_f32=False` and the wide strides;
tests/test_torch_options_denoiser.py holds `state_f32=False` and the float
`sigma_n` through `check_option_frames`.

Then K3's and K4's plain versions with a float `sigma_n` (`torch.pow`,
where an integer one takes the multiply chain) against
`temporal_accum_pallas_pair` and `wavelet_iter_pallas` in interpret mode.

Bars: >= 35 dB a frame; validity agreement >= 0.999; the kernels' plain
versions at tests/test_torch_svgf_kernels.py's rtol 1e-4 / atol 1e-5 with
identical NaN positions."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.ops import svgf_pallas as jsp
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig, SVGFConfig
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
from low_precision_raytracer_tpu_torch.ops import svgf_kernels as tsk
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_render_e2e import _psnr
from test_torch_svgf_kernels import H, T, W, _close, _crop, _data

TESTS = Path(__file__).resolve().parent
N = 32
FRAMES = 4
SIGMA_N = 127.5
WIDE = (1, 2, 4, 8, 16, 32, 64)

# (port config kw, JAX config kw)
CASES = {
    "shade_f32": (dict(shade_f32=False), dict(shade_f32=False)),
    "state_f32": (dict(svgf=SVGFConfig(state_f32=False), taa_mix_weight=0.3),
                  dict(svgf=JaxSVGF(wavelet_impl="pallas", state_f32=False),
                       taa_mix_weight=0.3)),
    "sigma_n": (dict(svgf=SVGFConfig(sigma_n=SIGMA_N)),
                dict(svgf=JaxSVGF(wavelet_impl="pallas", sigma_n=SIGMA_N))),
    "strides": (dict(svgf=SVGFConfig(strides=WIDE)),
                dict(svgf=JaxSVGF(wavelet_impl="xla", strides=WIDE))),
}


def _jax_draws(key, cfg):
    """The JAX `Renderer.render` key chain for one frame: -> (next key, the
    GI rounds' uniforms in the shade dtype, the TAA bits), as CPU tensors."""
    key, sub = jax.random.split(key)
    gi_rounds = cfg.max_bounces - 1 if cfg.gi_on else 0
    k_taa, k_shade0, *k_rounds = jax.random.split(sub, 2 + max(gi_rounds, 1))
    jdt = jnp.float32 if cfg.shade_f32 else jnp.bfloat16
    tdt = torch.float32 if cfg.shade_f32 else torch.bfloat16
    R = cfg.width * cfg.height
    us = [torch.from_numpy(np.array(jax.random.uniform(k, (7 * R,), jdt).astype(jnp.float32)))
          .to(tdt) for k in [k_shade0, *k_rounds][:gi_rounds]]
    bits = jax.random.bits(k_taa, (cfg.height, cfg.width), jnp.uint32)
    return key, us, torch.from_numpy(np.array(bits).astype(np.int64))


def jax_frames(case):
    """The JAX `Renderer`'s FRAMES frames of `case`: -> list of (image,
    validity, the port's draws (uniforms, TAA bits) as numpy), and the
    carried planes' dtype names."""
    _kw, jkw = CASES[case]
    jkw = {"svgf": JaxSVGF(wavelet_impl="pallas"), **jkw}
    jcfg = JaxConfig(width=N, height=N, precision="bf16", traversal_impl="dense_pallas", **jkw)
    jr = JaxRenderer(jax_cornell(), jcfg)
    key, frames = jr.key, []
    for _f in range(FRAMES):
        key, us, bits = _jax_draws(key, jcfg)
        img, aux = jr.render()
        frames.append((np.asarray(img), np.asarray(aux["valid"]),
                       [u.float().numpy() for u in us], bits.numpy()))
    return frames, (str(jr.state.taa_history.dtype),
                    str(jr.state.svgf_colored.color_history.dtype))


def _jax_frames_op_by_op(case):
    """`jax_frames(case)` in a fresh interpreter whose XLA rounds every
    bf16 operation to bf16 (`--xla_allow_excess_precision=false`), as the
    JAX package's code writes it and as the port computes."""
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "out.pkl")
        code = ("import sys, pickle, jax\n"
                "jax.config.update('jax_platforms', 'cpu')\n"
                f"sys.path[:0] = [{str(TESTS)!r}, {str(TESTS.parent)!r}]\n"
                "import test_torch_options as m\n"
                f"pickle.dump(m.jax_frames({case!r}), open({dst!r}, 'wb'))\n")
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "")
                             + " --xla_allow_excess_precision=false").strip()}
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        with open(dst, "rb") as fh:
            return pickle.load(fh)


def check_option_frames(case):
    """`case`'s frames against the JAX Renderer's.  The dtype shader
    (`shade_f32=False`) is held against the JAX Renderer with XLA's excess
    precision off: by default XLA keeps bf16 intermediates of a fused
    chain in f32, and the bf16 GI lobes turn such a change of an ulp into
    a different bounce (the jitted JAX frame falls below this bar against
    the same frame run op by op, which the port matches far above it)."""
    kw, _jkw = CASES[case]
    frames, dtypes = (_jax_frames_op_by_op if case == "shade_f32" else jax_frames)(case)
    tr = Renderer(cornell_box_scene(), RenderConfig(width=N, height=N, precision="bf16", **kw),
                  device="cpu")
    udt = torch.float32 if tr.cfg.shade_f32 else torch.bfloat16
    for f, (img_j, valid_j, us, bits) in enumerate(frames):
        img_t, aux_t = tr.render(uniforms=[torch.from_numpy(u).to(udt) for u in us],
                                 taa_bits=torch.from_numpy(bits))
        img_t = img_t.numpy()
        assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
        p = _psnr(img_t, img_j)
        assert p >= 35.0, f"{case} frame {f}: PSNR {p:.2f} dB"
        agree = valid_j == aux_t["valid"].numpy()
        assert agree.mean() >= 0.999, f"{case} frame {f}: valid agreement {agree.mean()}"
    # the carried planes in the dtype the JAX package holds them in
    got = (tr.state.taa_history.dtype, tr.state.svgf_colored.color_history.dtype)
    assert tuple(str(d).split(".")[-1] for d in got) == dtypes, case


# state_f32 and sigma_n run in tests/test_torch_options_denoiser.py, so
# that the four JAX compiles spread over two test processes
@pytest.mark.parametrize("case", ["shade_f32", "strides"])
def test_option_frames_match_jax(case):
    check_option_frames(case)


def test_temporal_accum_float_sigma_n_matches():
    """K3's plain version with sigma_n = 127.5 in both moment branches."""
    color2, _, depth, normal, grad, _ = _data()
    rng = np.random.default_rng(3)
    hist2 = rng.random((2, H, W, 3), dtype=np.float32)
    m1 = rng.random((2, H, W), dtype=np.float32)
    m2 = rng.random((2, H, W), dtype=np.float32) + 1.0
    fc = rng.integers(0, 9, (H, W)).astype(np.float32)  # both moment branches
    col6 = np.stack([color2[i, ..., c] for i in (0, 1) for c in range(3)])
    ctr11 = np.stack([hist2[i, ..., c] for i in (0, 1) for c in range(3)]
                     + [m1[0], m1[1], m2[0], m2[1], fc])
    jcfg = JaxSVGF(sigma_n=SIGMA_N)
    cfg = SVGFConfig(sigma_n=SIGMA_N)
    _, hp, wp = jsp._padded_dims(H, W)
    geo7_j, _ = jsp.pack_geometry_base(jnp.asarray(depth), jnp.asarray(grad),
                                       jnp.asarray(normal), jcfg)
    pad = lambda x: jsp._pad0(jnp.asarray(x), H, W, hp, wp)
    cv_j, ext_j, mst_j = jsp.temporal_accum_pallas_pair(
        pad(col6), geo7_j, pad(ctr11), jcfg, H=H, W=W, color_w=0.1, moments_w=0.1,
        interpret=True)
    geo7 = tsk.pack_geometry_base(T(depth), T(grad), T(normal), cfg)
    cv, ext, mst = tsk.temporal_accum(T(col6), geo7, T(ctr11), cfg, 0.1, 0.1)
    _close(cv.numpy(), _crop(cv_j), "cv")
    _close(ext.numpy(), _crop(ext_j), "ext")
    _close(mst.numpy(), _crop(mst_j), "mst")
    # the float exponent is taken: sigma_n = 128 gives other spatial moments
    cv128, _, mst128 = tsk.temporal_accum(T(col6), geo7, T(ctr11), SVGFConfig(), 0.1, 0.1)
    assert not torch.equal(mst, mst128)


@pytest.mark.parametrize("stride", [2, 16])
def test_wavelet_iter_float_sigma_n_matches(stride):
    """K4's plain version with sigma_n = 127.5."""
    color2, var2, depth, normal, grad, illum2 = _data(seed=stride)
    jcfg = JaxSVGF(sigma_n=SIGMA_N)
    cfg = SVGFConfig(sigma_n=SIGMA_N)
    j = lambda x: jnp.asarray(x)
    geo_j = jsp.pack_geometry_pair(j(depth), j(grad), j(normal), j(illum2), jcfg)
    cv_j = jsp.pack_cv_pair(j(color2), j(var2), jsp.geometry_valid2(j(depth), j(normal),
                                                                    j(illum2)))
    out_j = jsp.wavelet_iter_pallas(geo_j, cv_j, stride, jcfg, H=H, W=W, interpret=True)
    geo = torch.from_numpy(_crop(geo_j).copy())
    cv = torch.from_numpy(_crop(cv_j).copy())
    out = tsk.wavelet_iter(geo, cv, stride, cfg)
    _close(out.numpy(), _crop(out_j), f"cv stride {stride}")
    assert not torch.equal(out, tsk.wavelet_iter(geo, cv, stride, SVGFConfig()))

