"""Anchored long-video sampling (counterpart of the anchored half of
``mvldm_tpu/diffusion/video_sampling.py``; autoregressive sampling comes
with a later slice).

A scene is one context frame plus n target frames. Up to four strided
anchor frames are sampled from the context alone; further anchors come in
chained windows of three, each conditioned on [context0, previous anchor].
The remaining frames are assigned to their nearest anchor and sampled in
groups of three conditioned on [context0, anchor]; ragged tail groups are
padded by repeating the last view and the padding outputs dropped. Fill
groups batch along the batch axis in power-of-two chunks of at most
``max_parallel_groups``. The launch plan (positions, relative-pose index,
view counts, chunking) is the JAX package's, step for step.

There is no device mesh: scenes of a batch run on the engine's device.
Random draws come from the caller's ``torch.Generator``, consumed in launch
order. Launch outputs stay on the device until ``gather``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry.camera_utils import absolute_to_relative_camera
from .engine import DiffusionEngine


@dataclass
class SceneViews:
    """Host-side per-scene views."""

    images: np.ndarray       # (v, h, w, 3)
    extrinsics: np.ndarray   # (v, 4, 4)
    intrinsics: np.ndarray   # (v, 3, 3)
    index: np.ndarray        # (v,) frame ids


class VideoSampler:
    # (device launch output, [(flat row, scene slot, frame index)])
    ManyPending = List[Tuple[torch.Tensor, List[Tuple[int, int, int]]]]
    Pending = List[Tuple[torch.Tensor, List[Tuple[int, int]]]]

    def __init__(self, engine: DiffusionEngine, num_anchors_views: int = 4,
                 group_size: int = 3, max_parallel_groups: int = 16):
        self.engine = engine
        self.num_anchors = num_anchors_views
        self.group_size = group_size
        self.max_parallel_groups = max_parallel_groups

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @staticmethod
    def _to_u8(images: np.ndarray) -> np.ndarray:
        """Round-to-nearest quantization for upload (exact for k/255 floats)."""
        if images.dtype == np.uint8:
            return images
        return (np.clip(images, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr)).to(self.device)

    @staticmethod
    def _quantize(images: torch.Tensor) -> torch.Tensor:
        return (torch.clamp(images, 0.0, 1.0) * 255.0).to(torch.uint8)

    # ------------------------------------------------------------ launches

    def _sample(self, ctx_u8: torch.Tensor, extrinsics: torch.Tensor,
                intrinsics: torch.Tensor, num_target_views: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """(S, v_c) uint8 context -> (S, v_t, h, w, 3) uint8 targets."""
        images = ctx_u8.float() / 255.0
        out = self.engine.sample(images, extrinsics, intrinsics,
                                 num_target_views, generator)
        return self._quantize(out)

    def _sample_indexed_scenes(self, tables_u8: torch.Tensor,
                               ctx_idx: torch.Tensor, extrinsics: torch.Tensor,
                               intrinsics: torch.Tensor, num_target_views: int,
                               generator: Optional[torch.Generator]) -> torch.Tensor:
        """Fill launch: each scene's distinct context frames (S, U, h, w, 3)
        are VAE-encoded once and each of its g groups gathers its (ctx0,
        anchor) latents by ``ctx_idx`` (S, g, v_c). Returns (S*g, v_t, h, w,
        3) uint8."""
        eng = self.engine
        s = tables_u8.shape[0]
        g, v_c = ctx_idx.shape[1:3]
        table_latents = eng.encode_images(tables_u8.float() / 255.0, generator)
        rows = torch.arange(s, device=ctx_idx.device)[:, None, None]
        ctx_latents = table_latents[rows, ctx_idx]  # (S, g, v_c, hl, wl, 4)
        flat = ctx_latents.reshape(s * g, v_c, *ctx_latents.shape[3:])
        latents = eng.sample_latents(
            flat, extrinsics.reshape(s * g, *extrinsics.shape[2:]),
            intrinsics.reshape(s * g, *intrinsics.shape[2:]),
            num_target_views, generator)
        return self._quantize(eng.decode_latents(latents))

    def _make_launch(self, tgt_extr: np.ndarray, tgt_intr: np.ndarray):
        """One (S, v_c) ctx -> (S, v_t) launch on the per-scene cameras."""

        def launch(ctx_imgs, c_extr, c_intr, pos_padded, rel_index, v_t, generator):
            extr = np.concatenate([c_extr, tgt_extr[:, pos_padded]], axis=1)
            intr = np.concatenate([c_intr, tgt_intr[:, pos_padded]], axis=1)
            extr = absolute_to_relative_camera(self._tensor(extr), rel_index)
            return self._sample(ctx_imgs, extr, self._tensor(intr), v_t, generator)

        return launch

    @staticmethod
    def _pad_cols(idx, size: int) -> np.ndarray:
        """Pad a position index to a launch size by repeating its last entry."""
        idx = np.asarray(idx)
        if len(idx) == 0:
            raise ValueError("empty position index")
        if len(idx) == size:
            return idx
        return np.concatenate([idx, np.repeat(idx[-1:], size - len(idx))])

    @staticmethod
    def _take(views: SceneViews, idx) -> SceneViews:
        idx = np.asarray(idx)
        return SceneViews(images=views.images[idx], extrinsics=views.extrinsics[idx],
                          intrinsics=views.intrinsics[idx], index=views.index[idx])

    # ---------------------------------------------------------- gathering

    @staticmethod
    def gather(pending: "VideoSampler.Pending") -> Dict[int, np.ndarray]:
        results: Dict[int, np.ndarray] = {}
        for out, rows in pending:
            host = out.cpu().numpy().reshape(-1, *out.shape[-3:])
            for row, frame_index in rows:
                results[frame_index] = host[row]
        return results

    @staticmethod
    def gather_many(pending: "VideoSampler.ManyPending",
                    n_scenes: int) -> List[Dict[int, np.ndarray]]:
        results: List[Dict[int, np.ndarray]] = [{} for _ in range(n_scenes)]
        for out, rows in pending:
            host = out.cpu().numpy().reshape(-1, *out.shape[-3:])
            for row, scene, frame_index in rows:
                results[scene][frame_index] = host[row]
        return results

    # ------------------------------------------------------------ anchored

    def sample_anchored(self, context: SceneViews, target: SceneViews,
                        generator: Optional[torch.Generator] = None,
                        limit_frames: Optional[int] = None) -> Dict[int, np.ndarray]:
        return self.gather(self.dispatch_anchored(context, target, generator,
                                                  limit_frames))

    def dispatch_anchored(self, context: SceneViews, target: SceneViews,
                          generator: Optional[torch.Generator] = None,
                          limit_frames: Optional[int] = None) -> "VideoSampler.Pending":
        many = self.dispatch_anchored_many([(context, target)], generator,
                                           limit_frames)
        return [(out, [(row, f) for row, _, f in rows]) for out, rows in many]

    def sample_anchored_many(self, scenes: List[Tuple[SceneViews, SceneViews]],
                             generator: Optional[torch.Generator] = None,
                             limit_frames: Optional[int] = None
                             ) -> List[Dict[int, np.ndarray]]:
        return self.gather_many(
            self.dispatch_anchored_many(scenes, generator, limit_frames), len(scenes))

    def _prep_scene_batch(self, scenes, limit_frames):
        prep = []
        for ctx, tgt in scenes:
            if limit_frames is not None:
                tgt = self._take(tgt, np.arange(min(limit_frames, len(tgt.index))))
            prep.append((self._take(ctx, [0]), tgt))
        counts = {len(t.index) for _, t in prep}
        if len(counts) != 1:
            raise ValueError("dispatch_anchored_many requires equal target counts "
                             f"across the scene batch; got {sorted(counts)}")
        contexts = [c for c, _ in prep]
        targets = [t for _, t in prep]
        ctx_extr = np.stack([c.extrinsics for c in contexts])  # (S, 1, 4, 4)
        ctx_intr = np.stack([c.intrinsics for c in contexts])
        tgt_extr = np.stack([t.extrinsics for t in targets])   # (S, n_t, 4, 4)
        tgt_intr = np.stack([t.intrinsics for t in targets])
        ctx0_u8 = self._tensor(np.stack([self._to_u8(c.images) for c in contexts]))
        return targets, counts.pop(), ctx_extr, ctx_intr, tgt_extr, tgt_intr, ctx0_u8

    def dispatch_anchored_many(self, scenes: List[Tuple[SceneViews, SceneViews]],
                               generator: Optional[torch.Generator] = None,
                               limit_frames: Optional[int] = None
                               ) -> "VideoSampler.ManyPending":
        """Run a batch of scenes (equal target counts), scenes stacked along
        the batch axis of every launch; ``gather_many`` turns the result into
        per-scene {frame_index: uint8 image} dicts."""
        (targets, n_t, ctx_extr, ctx_intr, tgt_extr, tgt_intr,
         ctx0_u8) = self._prep_scene_batch(scenes, limit_frames)
        s = len(targets)

        n_anchors = min(self.num_anchors, n_t)
        anchor_step = max(n_t // n_anchors, 1)
        anchor_pos = np.arange(anchor_step, (n_anchors + 1) * anchor_step,
                               anchor_step)[:n_anchors]
        anchor_pos = anchor_pos[anchor_pos < n_t]
        if len(anchor_pos) == 0:
            anchor_pos = np.asarray([n_t - 1])  # n_t == 1: its own anchor

        pending: VideoSampler.ManyPending = []
        pad_cols = self._pad_cols
        launch = self._make_launch(tgt_extr, tgt_intr)

        # First window: up to four anchors from the context alone.
        first_n = min(len(anchor_pos), 4)
        first_bucket = min(self.num_anchors, 4)
        anchors = launch(ctx0_u8, ctx_extr, ctx_intr,
                         pad_cols(anchor_pos[:first_n], first_bucket),
                         rel_index=0, v_t=first_bucket, generator=generator)
        pending.append((anchors, [
            (sc * first_bucket + i, sc, int(targets[sc].index[pos]))
            for sc in range(s) for i, pos in enumerate(anchor_pos[:first_n])]))
        anchor_cols: List[torch.Tensor] = [anchors[:, i] for i in range(first_n)]

        # Chained anchor windows of group_size, each conditioned on
        # [context0, the previous window's last anchor], poses relative to it.
        last_anchor_pos = int(anchor_pos[first_n - 1])
        last_anchor_img = anchors[:, first_n - 1]
        start = first_n
        while start < len(anchor_pos):
            end = min(start + self.group_size, len(anchor_pos))
            ctx2_u8 = torch.cat([ctx0_u8, last_anchor_img[:, None]], dim=1)
            c2_extr = np.concatenate([ctx_extr, tgt_extr[:, [last_anchor_pos]]], axis=1)
            c2_intr = np.concatenate([ctx_intr, tgt_intr[:, [last_anchor_pos]]], axis=1)
            real = end - start
            imgs = launch(ctx2_u8, c2_extr, c2_intr,
                          pad_cols(anchor_pos[start:end], self.group_size),
                          rel_index=1, v_t=self.group_size, generator=generator)
            pending.append((imgs, [
                (sc * self.group_size + i, sc, int(targets[sc].index[pos]))
                for sc in range(s) for i, pos in enumerate(anchor_pos[start:end])]))
            anchor_cols.extend(imgs[:, i] for i in range(real))
            last_anchor_pos = int(anchor_pos[end - 1])
            last_anchor_img = imgs[:, real - 1]
            start = end

        # Remaining frames -> nearest anchor, grouped in frame order.
        anchor_set = set(anchor_pos.tolist())
        remaining = [p for p in range(n_t) if p not in anchor_set]
        anchor_of = {p: int(anchor_pos[np.argmin(np.abs(anchor_pos - p))])
                     for p in remaining}
        groups_by_anchor: Dict[int, List[List[int]]] = {int(a): [] for a in anchor_pos}
        current: List[int] = []
        current_anchor: Optional[int] = None
        for p in remaining:
            a = anchor_of[p]
            if current_anchor is None:
                current_anchor = a
            if a != current_anchor or len(current) == self.group_size:
                groups_by_anchor[current_anchor].append(current)
                current = []
                current_anchor = a
            current.append(p)
        if current:
            groups_by_anchor[current_anchor].append(current)

        # Per-scene context table: ctx0 + the anchors, padded to 1 + num_anchors.
        anchor_rank = {int(a): r for r, a in enumerate(anchor_pos)}
        table_cols = [ctx0_u8[:, 0]] + anchor_cols
        while len(table_cols) < 1 + self.num_anchors:
            table_cols.append(table_cols[-1])
        tables_u8 = torch.stack(table_cols, dim=1)  # (S, U, h, w, 3)

        jobs = []  # (ctx_idx (2,), anchor position, padded positions, group)
        for a_pos, groups in groups_by_anchor.items():
            ctx_idx = np.asarray([0, 1 + anchor_rank[int(a_pos)]], np.int64)
            for group in groups:
                jobs.append((ctx_idx, a_pos,
                             pad_cols(np.asarray(group), self.group_size), group))

        # Greedy power-of-two chunking of the fill jobs.
        cap = max(1, self.max_parallel_groups // s)
        cap = 1 << (cap.bit_length() - 1)
        buckets = []
        size = cap
        while size >= 1:
            buckets.append(size)
            size //= 2
        v_fill = self.group_size
        start = 0
        while start < len(jobs):
            left = len(jobs) - start
            bucket = next(b for b in buckets if b <= left or b == 1)
            chunk = jobs[start:start + min(bucket, left)]
            start += len(chunk)
            real_chunk = len(chunk)
            while len(chunk) < bucket:
                chunk.append(chunk[-1])
            ctx_idx = np.broadcast_to(np.stack([j[0] for j in chunk]),
                                      (s, bucket, 2)).copy()
            extr = np.stack([np.concatenate(
                [ctx_extr[:, 0:1], tgt_extr[:, [j[1]]], tgt_extr[:, j[2]]], axis=1)
                for j in chunk], axis=1)  # (S, g, 2 + group_size, 4, 4)
            intr = np.stack([np.concatenate(
                [ctx_intr[:, 0:1], tgt_intr[:, [j[1]]], tgt_intr[:, j[2]]], axis=1)
                for j in chunk], axis=1)
            extr = absolute_to_relative_camera(self._tensor(extr), 1)
            out = self._sample_indexed_scenes(
                tables_u8, self._tensor(ctx_idx), extr, self._tensor(intr),
                v_fill, generator)  # (S * g, v_t, h, w, 3)
            rows = []
            for sc in range(s):
                for g, (_, _, _, group) in enumerate(chunk[:real_chunk]):
                    rows.extend(((sc * bucket + g) * v_fill + i, sc,
                                 int(targets[sc].index[p]))
                                for i, p in enumerate(group))
            pending.append((out, rows))
        return pending
