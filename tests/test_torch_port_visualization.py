"""The port's ``visualization/`` against the JAX package's, on the CPU.

The numpy and Pillow modules (layout, annotation, cameras,
validation_in_3d, camera_trajectory) and ``apply_color_map`` compute the
same arrays: bitwise. ``drawing`` renders in torch what the JAX package
renders in jnp: within 1e-6 (f32 sums in another order); its projection
within 1e-5 of each coordinate.
``get_hist_image`` draws with numpy and Pillow, not matplotlib: it must
count what ``Axes.hist`` counts and draw a figure of the same size, one
bar a bin in proportion to its count.
"""

import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from mvldm_tpu.geometry.projection import project as jax_project
from mvldm_tpu.visualization import annotation as j_annotation
from mvldm_tpu.visualization import camera_trajectory as j_traj
from mvldm_tpu.visualization import cameras as j_cameras
from mvldm_tpu.visualization import color_map as j_color_map
from mvldm_tpu.visualization import drawing as j_drawing
from mvldm_tpu.visualization import layout as j_layout
from mvldm_tpu.visualization import validation_in_3d as j_val3d
from mvldm_tpu_torch.visualization import annotation, camera_trajectory, cameras, color_map
from mvldm_tpu_torch.visualization import drawing, layout, validation_in_3d

RNG = np.random.default_rng(0)


def images():
    return [RNG.uniform(size=(h, w, 3)).astype(np.float32) for h, w in ((20, 30), (24, 16))]


def poses(n: int) -> np.ndarray:
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = 0.3 * i
        out[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        out[i, :3, 3] = [0.5 * i, 0.1 * i, -0.2 * i]
    return out


def intrinsics(n: int) -> np.ndarray:
    k = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    k[:, 0, 0], k[:, 1, 1], k[:, :2, 2] = 0.9, 1.6, 0.5
    return k


@pytest.mark.parametrize("fn", ["hcat", "vcat"])
def test_layout_concatenation(fn):
    a, b = images()
    for kwargs in ({}, {"gap": 3, "gap_color": 0.0}):
        np.testing.assert_array_equal(getattr(layout, fn)(a, b, **kwargs),
                                      getattr(j_layout, fn)(a, b, **kwargs))


def test_layout_add_border():
    a, _ = images()
    np.testing.assert_array_equal(layout.add_border(a, 5, 0.5), j_layout.add_border(a, 5, 0.5))


def test_annotation():
    a, _ = images()
    np.testing.assert_array_equal(annotation.draw_text("Sampled Targets", 64),
                                  j_annotation.draw_text("Sampled Targets", 64))
    np.testing.assert_array_equal(annotation.add_label(a, "Context Views"),
                                  j_annotation.add_label(a, "Context Views"))


def test_cameras():
    e, k = poses(5), intrinsics(5)
    np.testing.assert_array_equal(cameras.frustum_segments(e[1], k[1], 0.2),
                                  j_cameras.frustum_segments(e[1], k[1], 0.2))
    segs = RNG.uniform(0, 63, size=(6, 2, 2)).astype(np.float32)
    np.testing.assert_array_equal(cameras._rasterize_lines(segs, cameras.DISTINCT_COLORS[:6], 64),
                                  j_cameras._rasterize_lines(segs, j_cameras.DISTINCT_COLORS[:6],
                                                             64))
    got, want = cameras.draw_cameras(64, e, k), j_cameras.draw_cameras(64, e, k)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_render_cameras_of_a_batch():
    e, k = poses(5), intrinsics(5)
    batch = {"context": {"extrinsics": e[None, :2], "intrinsics": k[None, :2]},
             "target": {"extrinsics": e[None, 2:], "intrinsics": k[None, 2:]}}
    for g, w in zip(validation_in_3d.render_cameras(batch, 48), j_val3d.render_cameras(batch, 48)):
        np.testing.assert_array_equal(g, w)
    del batch["target"]
    for g, w in zip(validation_in_3d.render_cameras(batch, 48), j_val3d.render_cameras(batch, 48)):
        np.testing.assert_array_equal(g, w)


def test_camera_trajectory():
    e = poses(3)
    t = np.linspace(0, 1, 7)
    q0, q1 = np.array([1.0, 0, 0, 0]), np.array([0.6, 0.8, 0, 0])
    np.testing.assert_array_equal(camera_trajectory._slerp(q0, q1, t), j_traj._slerp(q0, q1, t))
    np.testing.assert_array_equal(camera_trajectory._slerp(q0, q0, t), j_traj._slerp(q0, q0, t))
    np.testing.assert_array_equal(camera_trajectory.interpolate_pose(e[0], e[2], t),
                                  j_traj.interpolate_pose(e[0], e[2], t))
    np.testing.assert_array_equal(camera_trajectory.generate_wobble(e[1], 0.3, 12),
                                  j_traj.generate_wobble(e[1], 0.3, 12))
    np.testing.assert_array_equal(camera_trajectory.generate_spin(9, 20.0, 2.5),
                                  j_traj.generate_spin(9, 20.0, 2.5))


def test_color_maps():
    v = RNG.uniform(-0.2, 1.2, size=(7, 5)).astype(np.float32)
    np.testing.assert_array_equal(color_map.apply_color_map(v), j_color_map.apply_color_map(v))
    np.testing.assert_array_equal(color_map.apply_color_map(v, "viridis"),
                                  j_color_map.apply_color_map(v, "viridis"))
    np.testing.assert_array_equal(color_map.apply_depth_color_map(v * 5),
                                  j_color_map.apply_depth_color_map(v * 5))


@pytest.mark.parametrize("bins", [100, 7])
def test_hist_image_counts_what_matplotlib_counts(bins):
    values = RNG.normal(0.5, 0.2, size=(3, 16, 16, 3)).astype(np.float32)
    counts, edges = color_map.hist_counts(values, bins)
    fig, ax = plt.subplots()
    want_counts, want_edges, _ = ax.hist(values.reshape(-1), bins=bins)
    plt.close(fig)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(edges, want_edges)

    img = color_map.get_hist_image(values, bins=bins, title="Target Distribution")
    jax_img = j_color_map.get_hist_image(values, bins=bins, title="Target Distribution")
    assert img.shape == jax_img.shape == (400, 400, 3) and img.dtype == np.float32
    assert img.min() >= 0 and img.max() <= 1
    # Bar heights: the bar pixels in each bin's columns, in proportion to
    # its count (within a pixel of rounding).
    bar = np.all(np.abs(img * 255 - np.array(color_map.HIST_COLOR)) < 0.5, axis=-1)
    left, top, right, bottom = (color_map.HIST_MARGINS[0], color_map.HIST_MARGINS[1],
                                400 - color_map.HIST_MARGINS[2], 400 - color_map.HIST_MARGINS[3])
    width = (right - left) / bins
    scale = (bottom - top) / (counts.max() * 1.05)
    for i, c in enumerate(counts):
        col = left + round((i + 0.5) * width)
        assert abs(int(bar[:, col].sum()) - c * scale) <= 1.5, (i, c)
    # The title is drawn above the plot area.
    assert (img[:top, 100:300] < 0.5).any()


def test_drawing_lines_and_points_within_1e6():
    img = RNG.uniform(size=(24, 32, 3)).astype(np.float32)
    start = RNG.uniform(size=(4, 2)).astype(np.float32)
    end = RNG.uniform(size=(4, 2)).astype(np.float32)
    colors = RNG.uniform(size=(4, 3)).astype(np.float32)
    for color in (colors, colors[0]):
        got = drawing.render_lines(torch.from_numpy(img), torch.from_numpy(start),
                                   torch.from_numpy(end), torch.from_numpy(color), width=0.05)
        want = j_drawing.render_lines(jnp.asarray(img), jnp.asarray(start), jnp.asarray(end),
                                      jnp.asarray(color), width=0.05)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        got = drawing.render_points(torch.from_numpy(img), torch.from_numpy(start),
                                    torch.from_numpy(color), radius=0.08)
        want = j_drawing.render_points(jnp.asarray(img), jnp.asarray(start), jnp.asarray(color),
                                       radius=0.08)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_drawing_is_differentiable():
    start = torch.tensor([[0.1, 0.5]], requires_grad=True)
    out = drawing.render_lines(torch.zeros(16, 16, 3), start, torch.tensor([[0.9, 0.5]]),
                               torch.ones(3), width=0.05)
    (g,) = torch.autograd.grad(out.sum(), start)
    assert torch.isfinite(g).all() and (g != 0).any()


def test_project_points_within_1e5_relative():
    """x / z of camera-space points from f32 inverses of the poses (LAPACK
    here, XLA there): 1e-5 of each coordinate."""
    e, k = poses(3), intrinsics(3)
    pts = RNG.normal(size=(3, 10, 3)).astype(np.float32) * 2 + np.array([0, 0, 4], np.float32)
    xy, front = drawing.project_points(torch.from_numpy(pts), torch.from_numpy(e[:, None]),
                                       torch.from_numpy(k[:, None]))
    jxy, jfront = jax_project(jnp.asarray(pts), jnp.asarray(e[:, None]), jnp.asarray(k[:, None]))
    np.testing.assert_array_equal(front.numpy(), np.asarray(jfront))
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), rtol=1e-5, atol=1e-6)
