"""PyTorch port, the denoiser's options against the JAX `Renderer`:
`svgf.state_f32=False` (at TAA 0.3, where the history the JAX package
holds in bf16 is read) and a non-integer `svgf.sigma_n` (K3 and K4 take
`torch.pow` in their plain versions), 4 frames each of the bf16 flagship
at 32 x 32, the JAX side on its TPU route in interpret mode, the port fed
the JAX draws; >= 35 dB and validity agreement >= 0.999 a frame
(`tests/test_torch_options.py:check_option_frames`, where the other two
options run)."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import pytest

from test_torch_options import check_option_frames


@pytest.mark.parametrize("case", ["state_f32", "sigma_n"])
def test_option_frames_match_jax(case):
    check_option_frames(case)
