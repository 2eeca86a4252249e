"""Pipelined runtime: tracking and mapping decoupled (port of
como_tpu/runtime/pipeline.py).

Spec: reference como/odom/multiprocessing/{ComoMp,TrackingMp,MappingMp}.py,
a 2-stage asynchronous pipeline with bounded queues, drop-stale semantics
and "end" sentinels.  Here the stages are two host *threads* of one
process: tensors cross the queues by reference (nothing is serialized),
and both threads enqueue on their device's default stream, so on one GPU
device order is enqueue order and a hand-off needs no event.  The two
threads share the interpreter lock: queue waits release it (the native
ring, runtime/queues.py), kernel launches mostly do not.

Wiring (mirrors ComoMp.py:28-50):
    step()  --rgb_q(5, block)-->  tracking thread
    tracking  --pose_q(drop-stale)-->  step() return
    tracking  --frame_q(1, block)-->  mapping thread
    mapping  --kf_ref_q(drop-stale)-->  tracking
    mapping  --viz_q(drop-stale)-->  observer

Ownership: `Mapping` writes its window's slots in place, so whatever
crosses a queue owns its storage.  References are cloned out of the window
(`Mapping.get_kf_ref_data`), viewer data likewise (`get_kf_viz_data`), and
a `track_map` message holds the frame and the tracker's pose / affine
tensors, which the tracker rebinds and never writes in place.

A stage loop that raises stores its exception and closes every queue;
`step` and `shutdown` re-raise it, and `shutdown` raises if a thread is
still alive after its timeout.  No failure is swallowed and no caller
blocks for ever on a dead stage.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from como_tpu_torch.config import ComoConfig
from como_tpu_torch.odom.mapping import Mapping
from como_tpu_torch.odom.tracking import Tracking
from como_tpu_torch.runtime.placement import (device_scope, resolve_device,
                                              resolve_stage_devices, tree_device_put)
from como_tpu_torch.runtime.queues import make_queue
from como_tpu_torch.runtime.seq import frame_tensor, poses_numpy
from como_tpu_torch.utils.io import save_traj

_END = ("end",)


class ComoPipeline:
    def __init__(self, cfg: ComoConfig, intrinsics, img_size, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # per-stage placement: each stage thread makes its device current
        # and keeps its tensors there; messages crossing the stage boundary
        # move via tree_device_put (the reference's transfer-on-push)
        self.track_dev, self.map_dev = resolve_stage_devices(
            cfg.tracking.device, cfg.mapping.device, device)
        if cfg.mapping.mesh_devices >= 2:
            # multi-device BA: both stages on the engine's default device
            # (the mesh's first); mapping splits its GN steps over the mesh
            self.track_dev = self.map_dev = resolve_device(None, device)
        # decision_lag: handle_frame decides synchronously, yet the JAX
        # package passes dispatch_depth here (so kf_anticipate: -1
        # extrapolates the keyframe criterion over a lag that does not
        # exist).  The port is held against that package and computes the
        # same decisions; the finding is open in both (ROADMAP).
        with device_scope(self.track_dev):
            self.tracking = Tracking(cfg=cfg.tracking, intrinsics=intrinsics,
                                     img_size=tuple(img_size),
                                     decision_lag=cfg.dispatch_depth,
                                     device=self.track_dev)
        with device_scope(self.map_dev):
            self.mapping = Mapping(cfg.mapping, intrinsics, tuple(img_size),
                                   device=self.map_dev)
        self.rgb_q = make_queue(5)
        self.pose_q = make_queue(8)
        self.frame_q = make_queue(1)
        self.kf_ref_q = make_queue(2)
        self.viz_q = make_queue(2)
        self.timestamps: List[float] = []
        self.est_poses: List[np.ndarray] = []
        self.viz_listener = None
        self.frames_tracked = 0     # frames the tracking thread produced a pose for
        # per stage thread, filled when it ends: (CPU seconds of the thread,
        # wall seconds it lived).  Waiting (for a queue, for the interpreter
        # lock) is wall time only, so the two CPU shares sum to at most ~1
        # when the lock serialises the stages.
        self.stage_seconds: dict = {}
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None

    @property
    def poses_dropped(self) -> int:
        """Tracked frames whose pose never reached est_poses: pose_q keeps
        only the newest entry for a caller that polls slower than tracking
        produces."""
        return self.frames_tracked - len(self.est_poses)

    def _queues(self):
        return (self.rgb_q, self.pose_q, self.frame_q, self.kf_ref_q, self.viz_q)

    def setup(self):
        with device_scope(self.track_dev):
            self.tracking.setup()
        with device_scope(self.map_dev):
            self.mapping.setup()
        self._threads = [
            threading.Thread(target=self._stage, args=(self._tracking_loop,),
                             daemon=True, name="tracking"),
            threading.Thread(target=self._stage, args=(self._mapping_loop,),
                             daemon=True, name="mapping"),
        ]
        for t in self._threads:
            t.start()

    def _stage(self, loop):
        """Run one stage loop; on failure keep the exception and close the
        queues, which wakes the other stage and any blocked caller."""
        cpu0, wall0 = time.thread_time(), time.perf_counter()
        try:
            loop()
        except BaseException as e:  # noqa: BLE001  (re-raised by step / shutdown)
            if self._error is None:
                self._error = e
            for q in self._queues():
                q.close()
        finally:
            self.stage_seconds[threading.current_thread().name] = (
                time.thread_time() - cpu0, time.perf_counter() - wall0)

    def _raise_if_failed(self):
        if self._error is not None:
            raise RuntimeError(f"a pipeline stage failed: {self._error!r}") from self._error

    # -- tracking thread (reference TrackingMp.run) ---------------------------
    def _tracking_loop(self):
        with device_scope(self.track_dev):
            while self._error is None:
                kf_data = self.kf_ref_q.pop_until_latest(timeout=0.002)
                if kf_data is not None:
                    if kf_data[0] == "end":
                        self.pose_q.push(_END, block=False)
                        return
                    self.tracking.update_kf_reference(
                        tree_device_put(kf_data, self.track_dev))

                data = self.rgb_q.pop(timeout=0.002)
                if data is None:
                    continue
                if data[0] == "end":
                    self.frame_q.push(_END)
                    continue
                ts, rgb = data
                if not self.tracking.mapping_init:
                    self.frame_q.push(("init", ts, rgb))
                    continue
                rgb = frame_tensor(rgb, self.track_dev)
                track_viz, track_map = self.tracking.handle_frame(ts, rgb)
                self.frames_tracked += 1
                self.pose_q.push(track_viz, block=False)
                if track_map is not None:
                    self.frame_q.push(track_map)

    # -- mapping thread (reference MappingMp.run) ------------------------------
    def _mapping_loop(self):
        m = self.mapping
        last_ref_sent = 0.0
        with device_scope(self.map_dev):
            while self._error is None:
                kf_updated = False
                if not m.is_init:
                    data = self.frame_q.pop_until_latest(timeout=0.01)
                    if data is not None:
                        if data[0] == "end":
                            break
                        if data[0] == "init":
                            kf_updated = m.attempt_two_frame_init(
                                data[1], frame_tensor(data[2], self.map_dev))
                else:
                    data = self.frame_q.pop(timeout=0.005)
                    if data is not None:
                        if data[0] == "end":
                            break
                        if data[0] == "init":
                            pass  # stale bootstrap frame raced past init
                        else:
                            data = tree_device_put(data, self.map_dev)
                            kf_updated = m.handle_tracking_data(data)
                            if self.viz_listener is not None:
                                # K dense-depth products and host reads:
                                # only paid when an observer is attached
                                self.viz_q.push(m.get_kf_viz_data(), block=False)

                if m.is_init and m.maybe_iterate() is not None:
                    kf_updated = True

                now = time.monotonic()
                if m.is_init and (kf_updated or now - last_ref_sent > 1.0):
                    ref = m.get_kf_ref_data(self.cfg.mapping.track_ref_num_keyframes)
                    self.kf_ref_q.push(ref, block=False)
                    last_ref_sent = now

        self.kf_ref_q.push(_END, block=False)
        self.viz_q.push(_END, block=False)

    # -- host API ---------------------------------------------------------------
    def _record(self, msg):
        ts, T = msg
        if T is None:  # frame lost: hold the last finite pose
            T = self.est_poses[-1] if self.est_poses else np.eye(4, dtype=np.float32)
        out = T.detach().cpu().numpy() if isinstance(T, torch.Tensor) else np.array(T)
        self.timestamps.append(ts)
        self.est_poses.append(out)
        return out

    def step(self, timestamp: float, rgb):
        """Hand one frame to the tracking thread (waits while five are
        queued); returns the newest finished pose (numpy) or None."""
        self._raise_if_failed()
        if not self.rgb_q.push((timestamp, rgb), block=True):
            self._raise_if_failed()
            raise RuntimeError("the pipeline is shut down")
        out = None
        msg = self.pose_q.pop_until_latest()
        if msg is not None and msg[0] != "end":
            out = self._record(msg)
        if self.viz_listener is not None:
            viz = self.viz_q.pop_until_latest()
            if viz is not None and (not isinstance(viz, tuple) or viz[0] != "end"):
                self.viz_listener(viz)
        return out

    def shutdown(self, timeout: float = 30.0):
        """Send the end sentinel, wait for both stage threads and drain
        the final poses.  Raises a stage's stored exception, or
        RuntimeError if a thread is still alive after `timeout` seconds."""
        self.rgb_q.push(_END)
        t0 = time.monotonic()
        for t in self._threads:
            t.join(max(0.1, timeout - (time.monotonic() - t0)))
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            if self._error is None:
                self._error = RuntimeError(
                    f"stage thread(s) {alive} still alive {timeout} s after shutdown")
            for q in self._queues():
                q.close()
        self._raise_if_failed()
        while True:
            msg = self.pose_q.pop(timeout=0.05)
            if msg is None or msg[0] == "end":
                break
            self._record(msg)

    def poses_numpy(self) -> np.ndarray:
        return poses_numpy(self.est_poses)

    def save_trajectory(self, path: str):
        save_traj(path, self.timestamps, self.poses_numpy())
