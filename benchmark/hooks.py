"""Wraps around the port's layer entry points, installed for one run and
removed after it.  The package is never edited: a wrap replaces a module
attribute or an engine's bound method with a function that calls the
original.

Two uses:
- capture (every run): inside the window, the inputs and outputs of the
  calls the check judges (benchmark/check.py): every tracked frame's pose,
  affine and decision stats, every keyframe / one-way decision, a sample
  of GN steps drawn from the seed with the window state before and after,
  every keyframe insertion's prior, sampler calls, whole-image cross-covariance
  calls and predictor products.  Tensors are cloned on the device (no host
  read), so the window's timing is that of the program.
- spans (--trace 1): host spans around each layer's entry (tracking, gn,
  kf_insert, ow_insert, ref_update, decide) and around the port's Python
  entry of each roofline function (benchmark/rooflines/), with the
  function's shapes, read by the per-layer metrics.

Besides the wraps, the engine's own state is read at the window's start
and end (`ran_in_window`): the mapping's count of GN iterations and its
keyframes' timestamps.  So a GN step or an insertion that ran where no
wrap saw it (fused, graph-captured or renamed by a later change) shows up
as work the check was not given (benchmark/check.py, `uncaptured`).

`fault` breaks the timed path underneath, for the test that sees the check
fail: "state_unchanged" (the GN step hands back its input state and
tracking its initial pose), "half_sites" (tracking solves on half of the
reference's sites), "answer_altered" (each tracked pose moved by 1 cm where
it is produced, each prior's covariance image scaled by 1.5, each one-way
decision dropped), "gn_unhooked" / "insert_unhooked" (the GN step / the
insertion's prior and prediction run where the wraps do not reach, as
after a change that renames or fuses them: nothing of it is captured).
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
import time
import types

import torch

from benchmark import spec
from benchmark.layers import thread_keys

FAULTS = ("state_unchanged", "half_sites", "answer_altered", "gn_unhooked", "insert_unhooked")
GN_SAMPLE_P = 0.25          # the window's first GN step, then this share of the others,
GN_SAMPLE_MAX = 3           # up to this many


def merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            merge(dst[k], v)
        else:
            dst[k] = v


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


class Hooks:
    def __init__(self, eng, spans: bool, rng, fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")
        self.eng = eng
        self.spans, self.rng, self.fault = spans, rng, fault
        self.in_window = False
        self.tracer = None
        self.lock = threading.Lock()
        self.counts = {}                # calls of each layer entry in the window
        self._undo = []
        self.marks0 = None              # the engine's own marks at the window's start
        H, W = eng.mapping.img_size
        self.image_pixels = H * W
        self.ref = None                 # the newest keyframe reference handed to tracking
        self.refs = []                  # references that captured frames used
        self.captured = dict(track=[], decide=[], gn=[], insert=[], sampler=[], cross_cov=[],
                             spans=[], calls=[], refs=self.refs, engine={})

    # -- installing -----------------------------------------------------------
    def _patch(self, obj, name, make):
        if isinstance(obj, types.FunctionType):
            # a default argument of a function (bound when it was defined)
            names = [p.name for p in inspect.signature(obj).parameters.values()
                     if p.default is not inspect.Parameter.empty]
            defaults = list(obj.__defaults__)
            i = names.index(name)
            self._undo.append((obj, "__defaults__", obj.__defaults__, False))
            defaults[i] = make(defaults[i])
            obj.__defaults__ = tuple(defaults)
            return
        orig = getattr(obj, name)
        # a method patched on its instance is deleted again, which restores
        # the class's; a module attribute gets its object back
        self._undo.append((obj, name, orig, not isinstance(obj, types.ModuleType)))
        setattr(obj, name, make(orig))

    def install(self):
        import como_tpu_torch.gp.kernels as kernels_mod
        import como_tpu_torch.gp.sampler as sampler_mod
        import como_tpu_torch.odom.mapping as mapping_mod
        import como_tpu_torch.odom.tracking as tracking_mod
        import como_tpu_torch.runtime.seq as seq_mod

        t, m = self.eng.tracking, self.eng.mapping
        if self.spans:
            # first, so that the capture's copies run outside these spans
            for name in spec.roofline_names():
                spec.load_module("rooflines", name).install(self._roofline_patch(name))
        for mod in (seq_mod, tracking_mod):
            self._patch(mod, "track_frame", self._track_frame)
        if self.fault != "gn_unhooked":
            for mod in (seq_mod, mapping_mod):
                self._patch(mod, "_gn_step_impl", self._gn_step)
        self._patch(t, "update_kf_reference", self._update_ref)
        self._patch(t, "decide", self._decide)
        if self.fault != "insert_unhooked":
            self._patch(m, "add_keyframe_dispatch", self._insert)
        self._patch(m, "add_one_way_frame", lambda f: self._span(f, "ow_insert"))
        self._patch(m, "add_keyframe", self._kf_insert)
        self._patch(sampler_mod, "greedy_entropy_sample", self._sampler)
        self._patch(kernels_mod, "cross_covariance", self._cross_cov)

    def _roofline_patch(self, fname):
        def patch(obj, attr, shape_of):
            self._patch(obj, attr, lambda f: self._roofline_span(f, fname, shape_of))
        return patch

    def uninstall(self):
        for obj, name, orig, on_instance in reversed(self._undo):
            if on_instance:
                delattr(obj, name)
            else:
                setattr(obj, name, orig)
        self._undo = []

    def begin_window(self, tracer=None):
        self.tracer = tracer
        self.marks0 = self._engine_marks()
        self.in_window = True

    def end_window(self):
        self.in_window = False
        self.captured["engine"] = self.ran_in_window()

    # -- the engine's own state ---------------------------------------------------
    def _engine_marks(self) -> dict:
        """The mapping's count of GN iterations and its keyframes'
        timestamps (None where the engine has no such attribute)."""
        m = getattr(self.eng, "mapping", None)
        kf_ts = getattr(m, "kf_ts", None)
        return {"gn_iters": getattr(m, "total_iters", None),
                "kf_ts": None if kf_ts is None else list(kf_ts)}

    def ran_in_window(self) -> dict:
        """{"gn": GN iterations, "kf_insert": new keyframes} since the
        window's start, by the engine's own state; None where it does not
        show them."""
        a, b = self.marks0 or {}, self._engine_marks()
        gn = kf = None
        if a.get("gn_iters") is not None and b["gn_iters"] is not None:
            gn = b["gn_iters"] - a["gn_iters"]
        if a.get("kf_ts") is not None and b["kf_ts"] is not None:
            kf = len(set(b["kf_ts"]) - set(a["kf_ts"]))
        return {"gn": gn, "kf_insert": kf}

    def exercised(self, layer: str) -> bool:
        """Whether `layer` ("gn" or "kf_insert") ran since the window's
        start, by the engine's state where it shows it, else by the wraps."""
        n = self.ran_in_window()[layer]
        return bool(n) if n is not None else bool(self.counts.get(layer))

    # -- spans --------------------------------------------------------------------
    def _record(self, name, t0, extra=None):
        if self.in_window:
            self.counts[name] = self.counts.get(name, 0) + 1
        if self.spans and self.in_window:
            rec = (name, thread_keys(), t0, time.time_ns(),
                   self.tracer is not None and self.tracer.active, extra)
            with self.lock:
                self.captured["spans"].append(rec)

    def _span(self, f, name):
        def wrapped(*a, **k):
            t0 = time.time_ns()
            try:
                return f(*a, **k)
            finally:
                self._record(name, t0)
        return wrapped

    def _roofline_span(self, f, fname, shape_of):
        def wrapped(*a, **k):
            if not (self.in_window and self.tracer is not None and self.tracer.active):
                return f(*a, **k)
            t0 = time.time_ns()
            try:
                return f(*a, **k)
            finally:
                with self.lock:
                    self.captured["calls"].append((fname, thread_keys(), t0,
                                                   time.time_ns(), shape_of(*a, **k)))
        return wrapped

    def _kf_insert(self, f):
        def wrapped(*a, **k):
            t0 = time.time_ns()
            try:
                if self.in_window and self.tracer is not None:
                    return self.tracer.around_insert(lambda: f(*a, **k))
                return f(*a, **k)
            finally:
                self._record("kf_insert", t0)
        return wrapped

    # -- tracking -------------------------------------------------------------------
    def _update_ref(self, f):
        def wrapped(kf_data):
            t0 = time.time_ns()
            try:
                return f(kf_data)
            finally:
                # the tuple's tensors are clones the tracker only reads
                self.ref = dict(data=kf_data, index=None)
                self._record("ref_update", t0)
        return wrapped

    def _track_frame(self, f):
        def wrapped(levels, rgb, T_init, aff_init, T_w_kf, term, start_level, end_level,
                    img_hw, color="gray"):
            if self.fault == "half_sites" and self.in_window:
                levels = [type(lv)(vals=lv.vals[::2], P=lv.P[::2], J_ic=lv.J_ic[::2],
                                   mask=lv.mask[::2], K=lv.K) for lv in levels]
            t0 = time.time_ns()
            out = f(levels, rgb, T_init, aff_init, T_w_kf, term, start_level, end_level,
                    img_hw, color)
            if self.in_window and self.fault == "state_unchanged":
                Tji, aff, T_w_curr, stats = out
                out = (T_init, aff_init, T_w_curr, stats)
            if self.in_window and self.fault == "answer_altered":
                Tji, aff, T_w_curr, stats = out
                Tji = Tji.clone()
                Tji[0, 3] += 0.01
                out = (Tji, aff, T_w_curr, stats)
            self._record("tracking", t0)
            if self.in_window and self.ref is not None:
                ref = self.ref
                if ref["index"] is None:
                    ref["index"] = len(self.refs)
                    self.refs.append(ref["data"])
                self.captured["track"].append(dict(
                    ref=ref["index"], rgb_ptr=rgb.data_ptr(), T_init=_clone(T_init),
                    aff_init=_clone(aff_init), T_w_kf=_clone(T_w_kf), img_hw=tuple(img_hw),
                    out=_clone(out)))
            return out
        return wrapped

    def _decide(self, f):
        def wrapped(pending):
            t = self.eng.tracking
            before = None
            if self.in_window:
                before = dict(med_ema=t._med_ema, prev_motion=t._prev_motion,
                              last_kf_sent_ts=t.last_kf_sent_ts,
                              num_one_way_since_kf=t.num_one_way_since_kf,
                              decision_lag=t.decision_lag)
            t0 = time.time_ns()
            out = f(pending)
            if self.in_window and self.fault == "answer_altered" and out is not None \
                    and out[0] == "one-way":
                out = None
            self._record("decide", t0)
            if before is not None:
                from como_tpu_torch.odom.tracking import host_value
                self.captured["decide"].append(dict(
                    before=before, stats=host_value(pending, "stats").copy(),
                    ts=pending["ts"], kf_received_ts=pending["kf_received_ts"],
                    num_kf_pixels=pending["num_kf_pixels"],
                    promoted=bool(pending.get("promoted_kf")),
                    kind=None if out is None else out[0]))
            return out
        return wrapped

    # -- mapping ------------------------------------------------------------------------
    def _gn_step(self, f):
        def wrapped(state, pairs_ref, pairs_tgt, pairs_valid, K_intr, dims, sigmas, damping):
            n = len(self.captured["gn"])
            take = (self.in_window and n < GN_SAMPLE_MAX
                    and (n == 0 or self.rng.random() < GN_SAMPLE_P))
            before = _clone((state, pairs_ref, pairs_tgt, pairs_valid, K_intr)) if take else None
            t0 = time.time_ns()
            new_state, stats = f(state, pairs_ref, pairs_tgt, pairs_valid, K_intr, dims,
                                 sigmas, damping)
            if self.in_window and self.fault == "state_unchanged":
                new_state = state
            self._record("gn", t0)
            if take:
                keep = ("kf_pose", "kf_aff", "logzm", "ow_pose", "ow_aff", "P_lm")
                self.captured["gn"].append(dict(
                    inputs=before, dims=dims, sigmas=sigmas, damping=damping,
                    out={k: _clone(getattr(new_state, k)) for k in keep}))
            return new_state, stats
        return wrapped

    def _insert(self, f):
        def wrapped(rgb, pose_init, aff_init, timestamp):
            pend = f(rgb, pose_init, aff_init, timestamp)
            if self.in_window and self.fault == "answer_altered":
                pend["cov_img"] = pend["cov_img"] * 1.5
            if self.in_window:
                self.captured["insert"].append(dict(
                    rgb=_clone(rgb), cov_img=_clone(pend["cov_img"]),
                    coords=_clone(pend["res"].coords_all),
                    logzm=torch.log(torch.clamp(pend["res"].z_all, min=1e-9)).clone(),
                    Knm_full=_clone(pend["prep"]["Knm_full"])))
            return pend
        return wrapped

    def _sampler(self, f):
        def wrapped(domain_norm, e_domain, domain_valid, curr_norm, curr_e, curr_valid,
                    curr_var, signal_var, fixed_var=0.0, max_stdev_thresh=-1e8,
                    dist_thresh=0.0, num_slots=64, terminate_early=False):
            args = (domain_norm, e_domain, domain_valid, curr_norm, curr_e, curr_valid,
                    curr_var)
            kw = dict(signal_var=signal_var, fixed_var=fixed_var,
                      max_stdev_thresh=max_stdev_thresh, dist_thresh=dist_thresh,
                      num_slots=num_slots, terminate_early=terminate_early)
            before = _clone(args) if self.in_window else None
            res = f(*args, **kw)
            if before is not None:
                self.captured["sampler"].append(dict(inputs=before, kw=kw, out=_clone(res)))
            return res
        return wrapped

    def _cross_cov(self, f):
        def wrapped(x_n, e_n, x_m, e_m, scale):
            out = f(x_n, e_n, x_m, e_m, scale)
            # the calls over every pixel of the image (the insertion's dense
            # prediction) are captured whole
            if self.in_window and x_n.shape[0] >= self.image_pixels:
                self.captured["cross_cov"].append(dict(
                    inputs=_clone((x_n, e_n, x_m, e_m)), scale=float(scale), out=_clone(out)))
            return out
        return wrapped
