"""Streaming video interpolation (port of rife_tpu/video/pipeline.py;
reference inference_video.py:154-297).

A reader thread fills a bounded queue, the main thread queues the
engine's forwards on the device, and a writer thread drains a second
bounded queue and does every device -> host fetch.  The main thread
never waits on the device in the steady state: the scene gates run on
host probes of the source frames (video/probe.py).  On the card a fetch
in the writer thread waits, on the default stream, behind the forwards
the main thread queued before it; the queues' bounds keep the two within
`queue_size` frames of each other.

The reference's contract (SURVEY.md section 7):
- ssim_matlab of each pair's 32x32 bilinear probes (inference_video.py:
  226-228): > 0.996 is a static pair: read one frame ahead and put
  interpolate(I0, next) in place of the duplicate (:231-243); < 0.2 is a
  scene cut: 2^exp - 1 copies of I0 (:245-249);
- padding to the engine's `pad_multiple` (:199-202);
- `montage`: the centre half of each source frame beside the output
  (:196-205, 261-265);
- at 2X (one frame a gap) consecutive gaps go to the engine as one batch
  of `batch` pairs, a short flush padded to the full batch by repeating
  its last pair; deeper schedules take `midpoint_tree`, or
  `timestep_frames` for a timestep-conditioned model with
  `use_timestep`.

Prep (u8 -> the compute dtype, times 1/255 as rife_tpu's jitted graph
computes it, zero padding) and post (crop, f32, clip(y * 255 + 0.5),
u8) are plain PyTorch on the engine's device.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from rife_tpu_torch.engine.schedule import midpoint_tree, timestep_frames
from rife_tpu_torch.ops.pad import Padding, pad_to_multiple, plan_pad_to_multiple
from rife_tpu_torch.ops.resize import resize_bilinear
from rife_tpu_torch.video.probe import probe_small, ssim_probe

STATIC_SSIM = 0.996
SCENE_SSIM = 0.2


@dataclass
class VideoJob:
    exp: int = 1
    montage: bool = False
    tta: bool = False
    use_timestep: bool = False  # direct-t schedule for rife_m/v4.25
    queue_size: int = 64  # device frames held while queued
    batch: int = 4  # gap batching for the 2X path (exp == 1)


def prep(u8: np.ndarray, pad: Padding, dtype: torch.dtype, device) -> torch.Tensor:
    """An (H, W, 3) uint8 frame -> (1, H', W', 3) in `dtype` on `device`,
    in [0, 1] and zero padded.  Uploaded as u8 (a quarter of f32's
    bytes); the scale is a multiply by 1/255, which is what rife_tpu's
    jitted `u8.astype(dtype) / 255.0` computes (XLA's simplifier makes
    the division a multiply), bit for bit in f32 and bf16."""
    x = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
    x = x.to(dtype) * (1.0 / 255.0)
    return F.pad(x[None], (0, 0, pad.left, pad.right, pad.top, pad.bottom))


def post(frames: torch.Tensor, pad: Padding) -> np.ndarray:
    """(B, H', W', 3) frames on the device -> (B, H, W, 3) uint8 on the
    host: cropped, in f32, clip(y * 255 + 0.5, 0, 255), truncated; one
    fetch."""
    y = pad.crop(frames).float()
    return (y * 255.0 + 0.5).clamp_(0, 255).to(torch.uint8).cpu().numpy()


def device_probe(frame: torch.Tensor) -> np.ndarray:
    """The 32x32 f32 probe of a (1, H', W', 3) frame on the device, fetched
    (the static branch's synthesized frame exists only there)."""
    planes = frame.float().permute(0, 3, 1, 2)
    return resize_bilinear(planes, (32, 32))[0].permute(1, 2, 0).cpu().numpy()


def interpolate_video(engine, reader, writer, job: VideoJob) -> dict:
    """Stream frames from `reader` through `engine` into `writer`.

    Returns stats: frames in and out, static and scene-cut counts, seconds
    and fps_out, and the host seconds of the main thread's uploads
    (`upload_s`) and probes (`probe_s`) and of the writer's fetches
    (`fetch_s`, which include waiting for the device)."""
    n_out_per_gap = (1 << job.exp) - 1

    read_q: queue.Queue = queue.Queue(maxsize=job.queue_size)
    write_q: queue.Queue = queue.Queue(maxsize=job.queue_size)
    read_err: list = []
    write_err: list = []

    def read_loop():
        try:
            for frame in reader:
                read_q.put(frame)
        except Exception as e:  # surface decoder failures to the main thread
            read_err.append(e)
        finally:
            read_q.put(None)

    def write_loop():
        # Items: a device frame (1, H, W, C), or (batch, j) for a batched
        # midpoint; the last batch fetched is kept, so each batch crosses
        # to the host once.
        batch_cache: dict = {"dev": None, "u8": None}

        def conv(x):
            if isinstance(x, tuple):
                dev, j = x
                if batch_cache["dev"] is not dev:
                    batch_cache["dev"] = dev
                    batch_cache["u8"] = to_u8_host(dev)
                return batch_cache["u8"][j]
            return to_u8_host(x)[0]

        while True:
            item = write_q.get()
            if item is None:
                break
            if write_err:
                continue  # keep draining, so the main thread never blocks
            try:
                frame, orig = item
                with torch.inference_mode():
                    u8 = conv(frame)
                    if job.montage and orig is not None:
                        u8 = np.concatenate([conv(orig), u8], axis=1)
                writer.write(u8)
                stats["frames_out"] += 1
            except Exception as e:  # surface encoder failures to the main thread
                write_err.append(e)

    mult = engine.pad_multiple
    pad = None
    stats = {"frames_in": 0, "frames_out": 0, "static": 0, "scene_cut": 0,
             "upload_s": 0.0, "probe_s": 0.0, "fetch_s": 0.0}

    def to_u8_host(frames_dev) -> np.ndarray:
        t = time.perf_counter()
        out = post(frames_dev, pad)
        stats["fetch_s"] += time.perf_counter() - t
        return out

    rt = threading.Thread(target=read_loop, daemon=True)
    wt = threading.Thread(target=write_loop, daemon=True)
    rt.start()
    wt.start()
    t0 = time.perf_counter()

    def emit(frame, orig=None):
        write_q.put((frame, orig if job.montage else None))

    def device_frame(np_frame):
        # u8 frames are normalised and padded on the device; beside the
        # upload, the host probe of the scene gates.
        t = time.perf_counter()
        if np_frame.dtype == np.uint8:
            p0 = plan_pad_to_multiple(np_frame.shape[0], np_frame.shape[1], mult)
            dev = prep(np_frame, p0, engine.compute_dtype, engine.device)
        else:
            dev, p0 = pad_to_multiple(
                torch.from_numpy(np.ascontiguousarray(np_frame[None])).to(engine.device),
                mult)
        t1 = time.perf_counter()
        sm = probe_small(np_frame, (p0.top, p0.bottom, p0.left, p0.right))
        stats["upload_s"] += t1 - t
        stats["probe_s"] += time.perf_counter() - t1
        return dev, p0, sm

    def gate(sm0, sm1) -> float:
        t = time.perf_counter()
        s = ssim_probe(sm0, sm1)
        stats["probe_s"] += time.perf_counter() - t
        return s

    def interpolate_gap(a, b):
        if job.use_timestep and engine.supports_timestep:
            return timestep_frames(engine, a, b, n_out_per_gap, job.tta)
        return midpoint_tree(engine, a, b, n_out_per_gap, job.tta)

    def center_crop_montage(np_frame):
        # The reference montages the CENTRE HALF of the source
        # (inference_video.py:196-205: left = w//4, w = w//2, applied to
        # every read frame); the model runs on the cropped frames.
        w = np_frame.shape[1]
        left = w // 4
        return np_frame[:, left:left + w // 2]

    # --- ordered emission with deferred (batched) gap midpoints --------
    use_batching = (n_out_per_gap == 1 and not job.tta and not job.montage
                    and not (job.use_timestep and engine.supports_timestep)
                    and job.batch > 1)
    plan: list = []  # ('dev', frame, orig) | ('pend', idx, orig)
    pending: list = []  # (idx, I0, I1) awaiting a batched midpoint
    resolved: dict = {}

    def drain_plan(force=False):
        while plan:
            kind = plan[0][0]
            if kind == "dev":
                _, fr, orig = plan.pop(0)
                emit(fr, orig)
            else:
                _, idx, orig = plan[0]
                if idx not in resolved:
                    if not force:
                        return
                    flush_pending()
                    continue
                plan.pop(0)
                emit(resolved.pop(idx), orig)

    def flush_pending():
        if not pending:
            return
        # A short flush repeats its last pair up to the full batch, so
        # every batch has one shape.
        k = len(pending)
        items = pending + [pending[-1]] * (job.batch - k)
        i0s = torch.cat([p[1] for p in items], 0)
        i1s = torch.cat([p[2] for p in items], 0)
        mids = engine.interpolate(i0s, i1s, 0.5, job.tta)
        for j, (idx, _, _) in enumerate(pending):
            resolved[idx] = (mids, j)  # fetched batch-at-once in the writer
        pending.clear()

    pend_counter = [0]

    def queue_gap(a, b, orig):
        if not use_batching:
            for m in interpolate_gap(a, b):
                plan.append(("dev", m, orig))
            drain_plan()
            return
        idx = pend_counter[0]
        pend_counter[0] += 1
        pending.append((idx, a, b))
        plan.append(("pend", idx, orig))
        if len(pending) >= job.batch:
            flush_pending()
        drain_plan()

    def queue_frame(fr, orig=None):
        plan.append(("dev", fr, orig))
        drain_plan()

    def read_next():
        fr = read_q.get()
        if fr is None:
            return None
        stats["frames_in"] += 1
        if job.montage:
            fr = center_crop_montage(fr)
        return fr

    try:
        # The reference's temp/break_flag contract (inference_video.py:
        # 213-274): each iteration writes the SOURCE frame (`src`) then the
        # gap's frames.  On a static pair read one frame ahead, synthesize
        # interpolate(I0, next) as the REPLACEMENT of the duplicate (written
        # in its place and I0 of the next gap), re-run the scene gate on it,
        # and take the read-ahead frame next (carried in `temp`).  At the
        # end of the stream inside the static branch, synthesize against the
        # duplicate itself and stop after the gap (`break_flag`), never
        # reading the drained queue again.
        last = read_next()
        if last is None:
            return stats
        I1, pad, sm1 = device_frame(last)
        src = I1        # device frame due as the next source frame
        temp = None     # device read-ahead carried out of a static gate
        sm_temp = None  # its host probe

        while True:
            if temp is not None:
                I0, I1 = I1, temp
                sm0, sm1 = sm1, sm_temp
                temp = None
            else:
                nxt = read_next()
                if nxt is None:
                    break
                I0, sm0 = I1, sm1
                I1, _, sm1 = device_frame(nxt)

            s = gate(sm0, sm1)  # host-side: no device round trip
            break_flag = False
            if s > STATIC_SSIM:
                stats["static"] += 1
                after = read_next()
                if after is None:
                    break_flag = True
                    nxt_dev = I1  # the duplicate itself (ref: frame = lastframe)
                else:
                    nxt_dev, _, sm_temp = device_frame(after)
                    temp = nxt_dev
                I1 = engine.interpolate(I0, nxt_dev, 0.5, job.tta)
                # The synthesized frame exists only on the device: one small
                # fetch (a rare branch), then the gate again on the host.
                sm1 = device_probe(I1)
                s = gate(sm0, sm1)

            queue_frame(src, src)
            if s < SCENE_SSIM:
                stats["scene_cut"] += 1
                for _ in range(n_out_per_gap):
                    plan.append(("dev", I0, src))
                drain_plan()
            else:
                queue_gap(I0, I1, src)
            src = I1
            if break_flag:
                break

        queue_frame(src, src)
        drain_plan(force=True)
    finally:
        write_q.put(None)
        wt.join()
    if read_err:
        raise read_err[0]
    if write_err:
        raise write_err[0]
    dt = time.perf_counter() - t0
    stats["seconds"] = round(dt, 3)
    stats["fps_out"] = round(stats["frames_out"] / dt, 2) if dt > 0 else 0.0
    return stats
