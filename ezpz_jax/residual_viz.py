"""Residual-field visualization.

Renders a constraint's residual magnitude as a 2D scalar field — a sanity
check when changing residual math (the image should change). Mirrors the
reference's renderer look (``ezpz/src/residual_viz.rs``): turquoise where the
residual is near zero (the solution locus), ring-style grayscale elsewhere,
plus a red example point, green solution point, and a half-length arrow.

Batched twist: the field is one vmapped kernel evaluation over the whole
pixel grid (``residual_viz.rs:171-184`` samples per pixel in a scalar loop).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .ops.kernels import KERNELS

ZERO_RESIDUAL_THRESHOLD = 0.08
TURQUOISE = np.array([64, 224, 208], dtype=np.uint8)
RING_SCALE = 1.0

EXAMPLE_POINT = (3.0, 2.0)
DISTANCE_EXAMPLE_POINT = (4.5, 3.0)
PERP_DISTANCE_EXAMPLE_POINT = (-2.0, 5.0)
VERTICAL_HORIZONTAL_EXAMPLE_POINT = (3.0, 2.0)


class Viewport:
    def __init__(self, x_min, x_max, y_min, y_max, width, height):
        self.x_min, self.x_max = x_min, x_max
        self.y_min, self.y_max = y_min, y_max
        self.width, self.height = width, height

    def grid(self):
        """World coordinates of every pixel center, shape (H, W) each."""
        px = (np.arange(self.width) + 0.5) / self.width
        py = (np.arange(self.height) + 0.5) / self.height
        xs = self.x_min + (self.x_max - self.x_min) * px
        ys = self.y_min + (self.y_max - self.y_min) * py
        return np.meshgrid(xs, ys)

    def world_to_pixel(self, x, y):
        px = (x - self.x_min) / (self.x_max - self.x_min) * self.width
        py = (y - self.y_min) / (self.y_max - self.y_min) * self.height
        return int(round(px)), int(round(py))


def _mag_to_rgb(mag: np.ndarray) -> np.ndarray:
    """Vectorized ``mag_to_pixel`` (residual_viz.rs:72-81)."""
    value = mag * RING_SCALE
    frac = value - np.trunc(value)
    intensity = np.round(255.0 - frac * 255.0).astype(np.uint8)
    img = np.repeat(intensity[..., None], 3, axis=-1)
    img[mag < ZERO_RESIDUAL_THRESHOLD] = TURQUOISE
    return img


def render_field(viewport: Viewport, kernel_name: str, make_vars, params) -> np.ndarray:
    """Sample |residual| of one kernel over the grid with a single vmap.

    ``make_vars(x, y) -> (nvars,)`` builds the kernel variable vector with the
    grid point substituted in.
    """
    spec = KERNELS[kernel_name]
    X, Y = viewport.grid()
    pts = jnp.stack([jnp.asarray(X.ravel()), jnp.asarray(Y.ravel())], axis=1)
    p = jnp.asarray(np.asarray(params, dtype=np.float64))

    def sample(pt):
        v = make_vars(pt[0], pt[1])
        res, _deg = spec.fn(v, p)
        return jnp.sqrt(jnp.sum(res * res))

    mags = np.asarray(jax.jit(jax.vmap(sample))(pts)).reshape(X.shape)
    return _mag_to_rgb(mags)


# -- overlay drawing (pure numpy pixel ops) ---------------------------------


def _draw_filled_circle(img, cx, cy, radius_px, color):
    h, w = img.shape[:2]
    ys, xs = np.ogrid[-radius_px: radius_px + 1, -radius_px: radius_px + 1]
    mask = xs * xs + ys * ys <= radius_px * radius_px
    for dy in range(-radius_px, radius_px + 1):
        for dx in range(-radius_px, radius_px + 1):
            if mask[dy + radius_px, dx + radius_px]:
                px, py = cx + dx, cy + dy
                if 0 <= px < w and 0 <= py < h:
                    img[py, px] = color


def _draw_line(img, x0, y0, x1, y1, color):
    h, w = img.shape[:2]
    steps = max(abs(x1 - x0), abs(y1 - y0), 1)
    for i in range(steps + 1):
        t = i / steps
        px = int(round(x0 + (x1 - x0) * t))
        py = int(round(y0 + (y1 - y0) * t))
        if 0 <= px < w and 0 <= py < h:
            img[py, px] = color


def _draw_arrow(img, fx, fy, tx, ty, color, head_size_px=6, length_fraction=0.5):
    dx, dy = tx - fx, ty - fy
    ln = float(np.hypot(dx, dy))
    if ln < 1.0:
        return
    ux, uy = dx / ln, dy / ln
    actual = ln * length_fraction
    tip_x = fx + int(round(ux * actual))
    tip_y = fy + int(round(uy * actual))
    _draw_line(img, fx, fy, tip_x, tip_y, color)
    back_x = tip_x - int(round(ux * head_size_px))
    back_y = tip_y - int(round(uy * head_size_px))
    perp_x = int(round(-uy * head_size_px * 0.6))
    perp_y = int(round(ux * head_size_px * 0.6))
    _draw_line(img, tip_x, tip_y, back_x + perp_x, back_y + perp_y, color)
    _draw_line(img, tip_x, tip_y, back_x - perp_x, back_y - perp_y, color)
    _draw_line(img, back_x + perp_x, back_y + perp_y, back_x - perp_x, back_y - perp_y, color)


def _overlay(img, viewport, example_xy, solution_xy):
    ex = viewport.world_to_pixel(*example_xy)
    sol = viewport.world_to_pixel(*solution_xy)
    _draw_arrow(img, ex[0], ex[1], sol[0], sol[1], np.array([200, 0, 0], np.uint8))
    _draw_filled_circle(img, ex[0], ex[1], 5, np.array([255, 0, 0], np.uint8))
    _draw_filled_circle(img, sol[0], sol[1], 5, np.array([0, 180, 0], np.uint8))


# -- per-constraint renderers (residual_viz.rs:206-482) ----------------------


def render_points_coincident(fixed_x, fixed_y, x_min, x_max, y_min, y_max,
                             width, height) -> np.ndarray:
    vp = Viewport(x_min, x_max, y_min, y_max, width, height)
    img = render_field(
        vp, "points_coincident",
        lambda x, y: jnp.stack([x, y, jnp.asarray(fixed_x), jnp.asarray(fixed_y)]),
        np.zeros((0,)),
    )
    _overlay(img, vp, EXAMPLE_POINT, (fixed_x, fixed_y))
    return img


def render_distance(fixed_x, fixed_y, target, x_min, x_max, y_min, y_max,
                    width, height) -> np.ndarray:
    vp = Viewport(x_min, x_max, y_min, y_max, width, height)
    img = render_field(
        vp, "distance",
        lambda x, y: jnp.stack([x, y, jnp.asarray(fixed_x), jnp.asarray(fixed_y)]),
        np.array([target]),
    )
    # Solution: nearest point on the target circle from the example point.
    ex, ey = DISTANCE_EXAMPLE_POINT
    d = np.hypot(ex - fixed_x, ey - fixed_y)
    sx = fixed_x + (ex - fixed_x) / d * target
    sy = fixed_y + (ey - fixed_y) / d * target
    _overlay(img, vp, (ex, ey), (sx, sy))
    return img


def render_point_line_distance(p0, p1, target, x_min, x_max, y_min, y_max,
                               width, height) -> np.ndarray:
    vp = Viewport(x_min, x_max, y_min, y_max, width, height)
    img = render_field(
        vp, "point_line_distance",
        lambda x, y: jnp.stack([
            x, y,
            jnp.asarray(p0[0]), jnp.asarray(p0[1]),
            jnp.asarray(p1[0]), jnp.asarray(p1[1]),
        ]),
        np.array([target]),
    )
    # Solution: project the example point onto the signed-offset line.
    ex, ey = PERP_DISTANCE_EXAMPLE_POINT
    a = p0[1] - p1[1]
    b = p1[0] - p0[0]
    c = p0[0] * p1[1] - p1[0] * p0[1]
    norm = np.hypot(a, b)
    signed = (a * ex + b * ey + c) / norm
    shift = signed - target
    sx = ex - a / norm * shift
    sy = ey - b / norm * shift
    _overlay(img, vp, (ex, ey), (sx, sy))
    return img


def render_vertical(fixed_x, fixed_y, x_min, x_max, y_min, y_max,
                    width, height) -> np.ndarray:
    vp = Viewport(x_min, x_max, y_min, y_max, width, height)
    img = render_field(
        vp, "vertical",
        lambda x, y: jnp.stack([x, jnp.asarray(fixed_x)]),
        np.zeros((0,)),
    )
    ex, ey = VERTICAL_HORIZONTAL_EXAMPLE_POINT
    _overlay(img, vp, (ex, ey), (fixed_x, ey))
    return img


def render_horizontal(fixed_x, fixed_y, x_min, x_max, y_min, y_max,
                      width, height) -> np.ndarray:
    vp = Viewport(x_min, x_max, y_min, y_max, width, height)
    img = render_field(
        vp, "horizontal",
        lambda x, y: jnp.stack([y, jnp.asarray(fixed_y)]),
        np.zeros((0,)),
    )
    ex, ey = VERTICAL_HORIZONTAL_EXAMPLE_POINT
    _overlay(img, vp, (ex, ey), (ex, fixed_y))
    return img


def save_image(img: np.ndarray, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.image

    matplotlib.image.imsave(path, img)


def compare_images(a: np.ndarray, b: np.ndarray, tolerance: int = 8) -> float:
    """Fraction of pixels whose channels are all within ``tolerance`` — the
    visual-regression score (the reference uses twenty_twenty at 0.99)."""
    if a.shape != b.shape:
        return 0.0
    close = np.all(
        np.abs(a.astype(np.int16) - b.astype(np.int16)) <= tolerance, axis=-1
    )
    return float(close.mean())
