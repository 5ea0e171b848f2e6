"""PyTorch port, K2/K3/K4: the plain versions of the SVGF kernels against
the TPU kernels (`coef_fetch_pallas` through `fetch_weighted_packed`,
`temporal_accum_pallas_pair`, `wavelet_iter_pallas`) in interpret mode, on
the same f32 inputs with NaN pixels, the TPU outputs cropped to the image.

Bars: rtol 1e-4, atol 1e-5 and identical NaN positions.  Both sides run
the same f32 operations in the same order; what differs is the
transcendental implementations (exp, sqrt on XLA:CPU vs ATen, ~1 ulp) and
the 1/x rounding they feed, amplified at most ~10x by the cancellation in
var = m2 - m1^2."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.ops import svgf_pallas as jsp
from low_precision_raytracer_tpu.ops.reproject import (
    fetch_weighted_packed as jax_fetch_weighted_packed,
)
from low_precision_raytracer_tpu_torch.config import SVGFConfig
from low_precision_raytracer_tpu_torch.ops import svgf_kernels as tsk
from low_precision_raytracer_tpu_torch.ops.reproject import fetch_weighted_packed

H, W = 40, 96
CFG = SVGFConfig()
JCFG = JaxSVGF()


def _data(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s, dtype=np.float32)
    color2 = f(2, H, W, 3)
    var2 = f(2, H, W) + 0.01
    depth = f(H, W) * 5
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    grad = (rng.normal(size=(H, W, 2)) * 0.1).astype(np.float32)
    illum2 = f(2, H, W)
    # invalid pixels, as production has them: NaN colour/variance (sky),
    # NaN depth, one NaN gradient spot, one NaN illuminance spot
    color2[:, 5:9, 10:20] = np.nan
    var2[:, 5:9, 10:20] = np.nan
    depth[30:34, 50:60] = np.nan
    grad[12:14, 70:72] = np.nan
    illum2[1, 20:23, 3:6] = np.nan
    return color2, var2, depth, normal, grad, illum2


def _crop(x):
    return np.asarray(x)[:, jsp.PAD : jsp.PAD + H, jsp.PAD : jsp.PAD + W]


def _close(port, ref, name):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, name
    nan_p, nan_r = np.isnan(port), np.isnan(ref)
    np.testing.assert_array_equal(nan_p, nan_r, err_msg=f"{name}: NaN positions")
    np.testing.assert_allclose(port[~nan_p], ref[~nan_r], rtol=1e-4, atol=1e-5, err_msg=name)


T = torch.from_numpy


@pytest.mark.parametrize("branch", ["fast", "slow"])
def test_history_fetch_matches(branch):
    """K2 (fast shifted branch, coef_fetch_plain) and the plain 2x2-take
    branch against the JAX fetch, with a global motion that wraps."""
    rng = np.random.default_rng(1)
    hist = rng.random((10, H, W), dtype=np.float32)
    hist[:, 15:18, 40:44] = np.nan
    res_y = rng.integers(-1, 2, (H, W)).astype(np.int32)
    res_x = rng.integers(-1, 2, (H, W)).astype(np.int32)
    wgt = rng.random((H, W, 4), dtype=np.float32) * (rng.random((H, W, 4)) > 0.2)
    count = rng.integers(0, 5, (H, W)).astype(np.int32)
    my, mx = 1, -2
    row = np.arange(H, dtype=np.int32)[:, None]
    col = np.arange(W, dtype=np.int32)[None, :]
    by = np.clip(row + 1 + my + res_y, 0, H).astype(np.int32)
    bx = np.clip(col + 1 + mx + res_x, 0, W).astype(np.int32)
    ok = branch == "fast"
    ref = jax_fetch_weighted_packed(
        jnp.asarray(hist), jnp.asarray(by), jnp.asarray(bx), jnp.asarray(wgt),
        jnp.asarray(count),
        (jnp.int32(my), jnp.int32(mx), jnp.asarray(res_y), jnp.asarray(res_x), jnp.bool_(ok)),
        interpret=True)
    out, fast = fetch_weighted_packed(
        T(hist), T(by), T(bx), T(wgt), T(count),
        (torch.tensor(my, dtype=torch.int32), torch.tensor(mx, dtype=torch.int32),
         T(res_y), T(res_x), torch.tensor(ok)))
    assert fast == ok
    _close(out.numpy(), _crop(ref), f"fetch[{branch}]")


@pytest.mark.parametrize("fc_range", [(0, 4), (4, 9)], ids=["spatial", "temporal"])
def test_temporal_accum_matches(fc_range):
    """K3: frame counts below spatial_moments_below (bilateral moments) and
    at or above it (temporal moments)."""
    color2, _, depth, normal, grad, _ = _data()
    rng = np.random.default_rng(2)
    hist2 = rng.random((2, H, W, 3), dtype=np.float32)
    hist2[0, 25:27, 60:66] = np.nan
    m1 = rng.random((2, H, W), dtype=np.float32)
    m2 = rng.random((2, H, W), dtype=np.float32) + 1.0
    fc = rng.integers(*fc_range, (H, W)).astype(np.float32)
    col6 = np.stack([color2[i, ..., c] for i in (0, 1) for c in range(3)])
    ctr11 = np.stack([hist2[i, ..., c] for i in (0, 1) for c in range(3)]
                     + [m1[0], m1[1], m2[0], m2[1], fc])
    _, hp, wp = jsp._padded_dims(H, W)
    geo7_j, _ = jsp.pack_geometry_base(jnp.asarray(depth), jnp.asarray(grad),
                                       jnp.asarray(normal), JCFG)
    pad = lambda x: jsp._pad0(jnp.asarray(x), H, W, hp, wp)
    cv_j, ext_j, mst_j = jsp.temporal_accum_pallas_pair(
        pad(col6), geo7_j, pad(ctr11), JCFG, H=H, W=W, color_w=0.1,
        moments_w=0.1, interpret=True)

    geo7 = tsk.pack_geometry_base(T(depth), T(grad), T(normal), CFG)
    _close(geo7.numpy(), _crop(geo7_j), "geo7")
    cv, ext, mst = tsk.temporal_accum(T(col6), geo7, T(ctr11), CFG, 0.1, 0.1)
    _close(cv.numpy(), _crop(cv_j), "cv")
    _close(ext.numpy(), _crop(ext_j), "ext")
    _close(mst.numpy(), _crop(mst_j), "mst")
    assert (cv.numpy()[tsk.C_FC] == 0).any()  # the NaN-depth patch is masked


@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16])
def test_wavelet_iter_matches(stride):
    """K4 at every stride of the chain, both instances, with the packing."""
    color2, var2, depth, normal, grad, illum2 = _data(seed=stride)
    j = lambda x: jnp.asarray(x)
    geo_j = jsp.pack_geometry_pair(j(depth), j(grad), j(normal), j(illum2), JCFG)
    cv_j = jsp.pack_cv_pair(j(color2), j(var2), jsp.geometry_valid2(j(depth), j(normal), j(illum2)))
    out_j = jsp.wavelet_iter_pallas(geo_j, cv_j, stride, JCFG, H=H, W=W, interpret=True)

    geo7 = tsk.pack_geometry_base(T(depth), T(grad), T(normal), CFG)
    il2 = T(illum2)
    ext = torch.stack([torch.where(torch.isfinite(il2[i]), il2[i], 0.0) for i in (0, 1)]
                      + [torch.where(tsk.geometry_valid2(T(depth), T(normal), il2)[i], 0.0, tsk.BIG)
                         for i in (0, 1)])
    geo = torch.cat([geo7, ext])
    cv = tsk.pack_cv_pair(T(color2), T(var2), tsk.geometry_valid2(T(depth), T(normal), il2))
    np.testing.assert_array_equal(geo.numpy(), _crop(geo_j))
    np.testing.assert_array_equal(cv.numpy(), _crop(cv_j))
    out = tsk.wavelet_iter(geo, cv, stride, CFG)
    _close(out.numpy(), _crop(out_j), f"cv stride {stride}")
    color, var = tsk.unpack_cv_pair(out)
    cj, vj = jsp.unpack_cv_pair(out_j, H, W)
    _close(color.numpy(), cj, "unpacked colour")
    _close(var.numpy(), vj, "unpacked variance")
