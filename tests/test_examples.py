"""The example scripts must actually converge (CI-sized configurations).

These are the BASELINE config-3 acceptance paths: inverse rendering through
the differentiable soft renderer, including the shadow-only recovery of an
out-of-frustum occluder.
"""
import sys

import pytest


@pytest.mark.slow
def test_fit_from_shadow_converges():
    from examples.fit_from_shadow import main

    # The reference's aspect hack ties vertical FOV to the cell height
    # (Camera3D.cpp:17), so the shadow stays in frame only near the
    # example's default geometry; shrink the step count, not the image.
    rc = main(["--steps", "120"])
    assert rc == 0


@pytest.mark.slow
def test_inverse_render_converges():
    """Both phases of the annealed inverse render must reach sub-pixel
    error at the display-sharp tau=0.05."""
    from examples.inverse_render import main

    rc = main(["--steps", "150", "--width", "192", "--height", "96",
               "--perturb", "1.0"])
    assert rc == 0


@pytest.mark.slow
def test_inverse_render_quantized_converges():
    """Training THROUGH the ANSI-256-quantized console image (the
    quantize_rgb_ste straight-through head) still recovers geometry
    sub-pixel."""
    from examples.inverse_render import main

    rc = main(["--steps", "150", "--width", "192", "--height", "96",
               "--perturb", "1.0", "--quantized"])
    assert rc == 0
