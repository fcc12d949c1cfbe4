"""Visual regression for residual-field rendering (residual_viz.rs:484-582).

Baselines are committed under tests/residual_viz_baselines/. Regenerate with
TWENTY_TWENTY=overwrite python -m pytest tests/test_residual_viz.py
"""

import os

import numpy as np
import pytest

from ezpz_jax import residual_viz as rv

BASELINE_DIR = os.path.join(os.path.dirname(__file__), "residual_viz_baselines")
SCORE = 0.99


def _render(name):
    if name == "points_coincident":
        return rv.render_points_coincident(3.0, 2.0, -6, 6, -6, 6, 240, 240)
    if name == "distance":
        return rv.render_distance(0.0, 0.0, 3.0, -6, 6, -6, 6, 240, 240)
    if name == "point_line_distance":
        return rv.render_point_line_distance((0.0, 0.0), (2.0, 3.0), 1.0,
                                             -6, 6, -6, 6, 240, 240)
    if name == "vertical":
        return rv.render_vertical(1.0, 0.0, -6, 6, -6, 6, 240, 240)
    if name == "horizontal":
        return rv.render_horizontal(0.0, 1.0, -6, 6, -6, 6, 240, 240)
    raise ValueError(name)


@pytest.mark.parametrize(
    "name",
    ["points_coincident", "distance", "point_line_distance", "vertical", "horizontal"],
)
def test_residual_field_matches_baseline(name):
    img = _render(name)
    assert img.dtype == np.uint8 and img.ndim == 3
    path = os.path.join(BASELINE_DIR, f"{name}.png")
    if os.environ.get("TWENTY_TWENTY") == "overwrite" or not os.path.exists(path):
        os.makedirs(BASELINE_DIR, exist_ok=True)
        rv.save_image(img, path)
        if os.environ.get("TWENTY_TWENTY") != "overwrite":
            pytest.skip(f"baseline created at {path}; rerun to compare")
        return
    import matplotlib.image

    baseline = (matplotlib.image.imread(path) * 255).astype(np.uint8)[..., :3]
    score = rv.compare_images(img, baseline)
    assert score >= SCORE, f"{name}: visual score {score} < {SCORE}"


def test_zero_locus_is_marked():
    """The solution set must be turquoise: for distance, the target circle."""
    img = rv.render_distance(0.0, 0.0, 3.0, -6, 6, -6, 6, 240, 240)
    # Pixel at world (3, 0): on the circle.
    vp = rv.Viewport(-6, 6, -6, 6, 240, 240)
    px, py = vp.world_to_pixel(3.0, 0.0)
    assert tuple(img[py, px]) == tuple(rv.TURQUOISE)
    # Pixel at world (-5.5, -5.5): far off the circle, not turquoise.
    px, py = vp.world_to_pixel(-5.5, -5.5)
    assert tuple(img[py, px]) != tuple(rv.TURQUOISE)
