"""Long-video sampling, anchored and autoregressive (counterpart of
``mvldm_tpu/diffusion/video_sampling.py``).

A scene is one context frame plus n target frames.

* Anchored: up to four strided anchor frames are sampled from the context
  alone; further anchors come in chained windows of three, each
  conditioned on [context0, previous anchor]. The remaining frames are
  assigned to their nearest anchor and sampled in groups of three
  conditioned on [context0, anchor]. Fill groups batch along the batch axis
  in power-of-two chunks of at most ``max_parallel_groups``.
* Autoregressive: the first ``num_anchors_views`` targets from the context,
  then sliding windows of three conditioned on [context0, the last frame
  generated]. With ``ar_latent_feedthrough`` the context is encoded once
  and each window conditions on the previous window's latent itself; the
  decode runs for export only.

Ragged tail groups are padded by repeating the last view and the padding
outputs dropped. The launch plan (positions, relative-pose index, view
counts, chunking) is the JAX package's, step for step.

There is no device mesh: scenes of a batch run on the engine's device.
Random draws come from the caller's ``torch.Generator``, consumed in launch
order. Launch outputs stay on the device until ``gather``: each window's
context is a device slice of the window before, with no host sync inside
a chain.

The host's part is spanned (``utils/profiling.py``): a dispatch
(``sampler.dispatch``), each launch in it (``sampler.launch``) and the
gather (``sampler.gather``), and each call that holds the host until the
device has drained: the pageable uploads (``sync.upload``), the relative
poses' index and inverse (``sync.pose_index``, ``sync.relative_pose``) and
each copy to the host (``sync.gather``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry.camera_utils import absolute_to_relative_camera
from ..utils.profiling import span, sync
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
                 group_size: int = 3, max_parallel_groups: int = 16,
                 ar_latent_feedthrough: bool = False):
        self.engine = engine
        self.num_anchors = num_anchors_views
        self.group_size = group_size
        self.max_parallel_groups = max_parallel_groups
        self.ar_latent_feedthrough = ar_latent_feedthrough

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
        """A host array on the engine's device: a pageable copy."""
        with sync("upload"):
            return torch.as_tensor(np.ascontiguousarray(arr)).to(self.device)

    def _relative(self, extr: np.ndarray, rel_index: int) -> torch.Tensor:
        """Host poses (..., v, 4, 4) on the device, relative to view ``rel_index``."""
        extr = self._tensor(extr)
        with sync("relative_pose"):
            return absolute_to_relative_camera(extr, rel_index)

    @staticmethod
    def _launch_span(kind: str, rows: int, v_c: int, v_t: int) -> span:
        return span("sampler.launch", {"kind": kind, "rows": rows, "v_c": v_c, "v_t": v_t})

    @staticmethod
    def _dispatch_span(kind: str, scenes, limit_frames: Optional[int]) -> span:
        frames = sum(len(t.index) if limit_frames is None else min(limit_frames, len(t.index))
                     for _, t in scenes)
        return span("sampler.dispatch", {"kind": kind, "scenes": len(scenes), "frames": frames})

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
        return self._decode_u8(latents)

    def _encode_ctx(self, ctx_u8: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        """(S, v, h, w, 3) uint8 -> (S, v, hl, wl, 4) latents."""
        return self.engine.encode_images(ctx_u8.float() / 255.0, generator)

    def _sample_latents(self, ctx_latents: torch.Tensor, extrinsics: torch.Tensor,
                        intrinsics: torch.Tensor, num_target_views: int,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
        return self.engine.sample_latents(ctx_latents, extrinsics, intrinsics,
                                          num_target_views, generator)

    def _decode_u8(self, latents: torch.Tensor) -> torch.Tensor:
        return self._quantize(self.engine.decode_latents(latents))

    def _make_launch(self, tgt_extr: np.ndarray, tgt_intr: np.ndarray):
        """One (S, v_c) ctx -> (S, v_t) launch on the per-scene cameras."""

        def launch(ctx_imgs, c_extr, c_intr, pos_padded, rel_index, v_t, generator):
            extr = np.concatenate([c_extr, tgt_extr[:, pos_padded]], axis=1)
            intr = np.concatenate([c_intr, tgt_intr[:, pos_padded]], axis=1)
            extr = self._relative(extr, rel_index)
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
    def _host(out: torch.Tensor) -> np.ndarray:
        """A launch output's frames on the host, (rows, h, w, 3)."""
        with sync("gather"):
            return out.cpu().numpy().reshape(-1, *out.shape[-3:])

    @staticmethod
    @span("sampler.gather")
    def gather(pending: "VideoSampler.Pending") -> Dict[int, np.ndarray]:
        results: Dict[int, np.ndarray] = {}
        for out, rows in pending:
            host = VideoSampler._host(out)
            for row, frame_index in rows:
                results[frame_index] = host[row]
        return results

    @staticmethod
    @span("sampler.gather")
    def gather_many(pending: "VideoSampler.ManyPending",
                    n_scenes: int) -> List[Dict[int, np.ndarray]]:
        results: List[Dict[int, np.ndarray]] = [{} for _ in range(n_scenes)]
        for out, rows in pending:
            host = VideoSampler._host(out)
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

    def _prep_scene_batch(self, scenes, limit_frames, what: str = "dispatch_anchored_many"):
        prep = []
        for ctx, tgt in scenes:
            if limit_frames is not None:
                tgt = self._take(tgt, np.arange(min(limit_frames, len(tgt.index))))
            prep.append((self._take(ctx, [0]), tgt))
        counts = {len(t.index) for _, t in prep}
        if len(counts) != 1:
            raise ValueError(f"{what} requires equal target counts across the "
                             f"scene batch; got {sorted(counts)}")
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
        with self._dispatch_span("anchored", scenes, limit_frames):
            return self._anchored_many(scenes, generator, limit_frames)

    def _anchored_many(self, scenes, generator, limit_frames) -> "VideoSampler.ManyPending":
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
        with self._launch_span("anchor", s, 1, first_bucket):
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
            with self._launch_span("chain", s, 2, self.group_size):
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
            with self._launch_span("fill", s * bucket, 2, v_fill):
                ctx_idx = np.broadcast_to(np.stack([j[0] for j in chunk]),
                                          (s, bucket, 2)).copy()
                extr = np.stack([np.concatenate(
                    [ctx_extr[:, 0:1], tgt_extr[:, [j[1]]], tgt_extr[:, j[2]]], axis=1)
                    for j in chunk], axis=1)  # (S, g, 2 + group_size, 4, 4)
                intr = np.stack([np.concatenate(
                    [ctx_intr[:, 0:1], tgt_intr[:, [j[1]]], tgt_intr[:, j[2]]], axis=1)
                    for j in chunk], axis=1)
                extr = self._relative(extr, 1)
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

    # ------------------------------------------------------- autoregressive

    def sample_autoregressive_many(self, scenes: List[Tuple[SceneViews, SceneViews]],
                                   generator: Optional[torch.Generator] = None,
                                   limit_frames: Optional[int] = None
                                   ) -> List[Dict[int, np.ndarray]]:
        return self.gather_many(
            self.dispatch_autoregressive_many(scenes, generator, limit_frames),
            len(scenes))

    def dispatch_autoregressive_many(self, scenes: List[Tuple[SceneViews, SceneViews]],
                                     generator: Optional[torch.Generator] = None,
                                     limit_frames: Optional[int] = None
                                     ) -> "VideoSampler.ManyPending":
        """S scenes (equal target counts) advance their windows in lockstep,
        stacked along the batch axis of every launch."""
        with self._dispatch_span("autoregressive", scenes, limit_frames):
            return self._autoregressive_many(scenes, generator, limit_frames)

    def _autoregressive_many(self, scenes, generator, limit_frames
                             ) -> "VideoSampler.ManyPending":
        (targets, n_t, ctx_extr, ctx_intr, tgt_extr, tgt_intr,
         ctx0_u8) = self._prep_scene_batch(scenes, limit_frames,
                                           "dispatch_autoregressive_many")
        s = len(targets)
        n_initial = min(self.num_anchors, n_t)
        feed_latents = self.ar_latent_feedthrough

        if feed_latents:
            ctx0 = self._encode_ctx(ctx0_u8, generator)

            def launch(ctx_lat, c_extr, c_intr, pos_padded, rel_index, v_t, generator):
                extr = np.concatenate([c_extr, tgt_extr[:, pos_padded]], axis=1)
                intr = np.concatenate([c_intr, tgt_intr[:, pos_padded]], axis=1)
                extr = self._relative(extr, rel_index)
                return self._sample_latents(ctx_lat, extr, self._tensor(intr), v_t,
                                            generator)
        else:
            ctx0 = ctx0_u8
            launch = self._make_launch(tgt_extr, tgt_intr)

        def submit(out, width, positions):
            images = self._decode_u8(out) if feed_latents else out
            pending.append((images, [
                (sc * width + i, sc, int(targets[sc].index[p]))
                for sc in range(s) for i, p in enumerate(positions)]))

        pending: VideoSampler.ManyPending = []
        with self._launch_span("ar", s, 1, self.num_anchors):
            out = launch(ctx0, ctx_extr, ctx_intr,
                         self._pad_cols(np.arange(n_initial), self.num_anchors),
                         rel_index=0, v_t=self.num_anchors, generator=generator)
            submit(out, self.num_anchors, range(n_initial))
        last_pos, last = n_initial - 1, out[:, n_initial - 1]
        start = n_initial
        while start < n_t:
            end = min(start + self.group_size, n_t)
            ctx2 = torch.cat([ctx0, last[:, None]], dim=1)
            c2_extr = np.concatenate([ctx_extr, tgt_extr[:, [last_pos]]], axis=1)
            c2_intr = np.concatenate([ctx_intr, tgt_intr[:, [last_pos]]], axis=1)
            with self._launch_span("ar", s, 2, self.group_size):
                out = launch(ctx2, c2_extr, c2_intr,
                             self._pad_cols(np.arange(start, end), self.group_size),
                             rel_index=1, v_t=self.group_size, generator=generator)
                submit(out, self.group_size, range(start, end))
            last_pos, last = end - 1, out[:, end - 1 - start]
            start = end
        return pending

    def sample_autoregressive(self, context: SceneViews, target: SceneViews,
                              generator: Optional[torch.Generator] = None,
                              limit_frames: Optional[int] = None) -> Dict[int, np.ndarray]:
        return self.gather(self.dispatch_autoregressive(context, target, generator,
                                                        limit_frames))

    def _run(self, ctx_u8: torch.Tensor, c_extr: np.ndarray, c_intr: np.ndarray,
             t_extr: np.ndarray, t_intr: np.ndarray, rel_index: int,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        """One single-scene launch: (v_c, h, w, 3) uint8 context on the
        device -> (v_t, h, w, 3) uint8 targets on the device."""
        with self._launch_span("ar", 1, len(c_extr), len(t_extr)):
            extr = np.concatenate([c_extr, t_extr], axis=0)[None]
            intr = np.concatenate([c_intr, t_intr], axis=0)[None]
            extr = self._relative(extr, rel_index)
            return self._sample(ctx_u8[None], extr, self._tensor(intr), len(t_extr),
                                generator)[0]

    @span("sampler.dispatch", {"kind": "autoregressive", "scenes": 1})
    def dispatch_autoregressive(self, context: SceneViews, target: SceneViews,
                                generator: Optional[torch.Generator] = None,
                                limit_frames: Optional[int] = None
                                ) -> "VideoSampler.Pending":
        """The single-scene chain, the JAX package's own path beside the
        scene-batched one (images fed back; it takes no latent
        feedthrough). At S = 1 it runs the launches of
        ``dispatch_autoregressive_many`` with the same draws."""
        if limit_frames is not None:
            target = self._take(target, np.arange(min(limit_frames, len(target.index))))
        ctx_u8 = self._tensor(self._to_u8(context.images[:1]))
        c_extr, c_intr = context.extrinsics[:1], context.intrinsics[:1]
        n_t = len(target.index)
        n_initial = min(self.num_anchors, n_t)

        pending: VideoSampler.Pending = []
        pos = self._pad_cols(np.arange(n_initial), self.num_anchors)
        images = self._run(ctx_u8, c_extr, c_intr, target.extrinsics[pos],
                           target.intrinsics[pos], 0, generator)[:n_initial]
        pending.append((images, [(i, int(target.index[i])) for i in range(n_initial)]))
        last_pos, last = n_initial - 1, images[n_initial - 1]
        start = n_initial
        while start < n_t:
            end = min(start + self.group_size, n_t)
            pos = self._pad_cols(np.arange(start, end), self.group_size)
            images = self._run(
                torch.cat([ctx_u8, last[None]]),
                np.concatenate([c_extr, target.extrinsics[[last_pos]]]),
                np.concatenate([c_intr, target.intrinsics[[last_pos]]]),
                target.extrinsics[pos], target.intrinsics[pos], 1, generator)[:end - start]
            pending.append((images, [(i, int(target.index[p]))
                                     for i, p in enumerate(range(start, end))]))
            last_pos, last = end - 1, images[end - 1 - start]
            start = end
        return pending
