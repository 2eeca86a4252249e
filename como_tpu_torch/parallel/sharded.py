"""Multi-device mapping: the photometric BA linearization sharded over a
mesh of devices (port of como_tpu/parallel/sharded.py).

The JAX package runs one `shard_map` program over a 1-D mesh ("ba",): the
window state is replicated, the pair arrays are split into contiguous
blocks, each device linearizes its block, the robust MAD sigma stays
global through psum'd histograms, and the six photometric outputs (frame
grids) are psum'd before the replicated prior factors, Cholesky and
retraction.

`shard_map` is single-controller over the local devices, so the
counterpart here is one process that loops over the shards (not
torch.distributed, which would also refuse two ranks on one GPU).  A mesh
is a list of torch devices, one per shard; a device may repeat, since a
shard is the unit of work.  One step:
  1. scaffold and dense points on the mapping device (the state's);
  2. per shard, the inputs of the residual half move to the shard's device
     (a tensor already there is not copied; the full-image GP `Knm_full`,
     113 MB at the default window, only when the occlusion gate is on);
  3. per shard, the residual half of `_photo`;
  4. the global sigma (ops/reduce.fast_mad_sigma_shards): bitwise the
     single-device sigma;
  5. per shard, the per-pair Jacobian blocks under that sigma (the
     photometric einsums over every dense site: the step's heavy work);
  6. the per-pair blocks concatenated onto the mapping device in shard
     order (1.4 MB at the default window's 64 pairs, the size of the JAX
     package's psum'd grids) and accumulated into the frame grids there,
     once over all pairs;
  7. `_finish` (priors, Cholesky, retraction) there.
Step 6 departs from the JAX package's psum of per-shard grids: summing
the shards' grids reassociates the f32 Hessian, and the solve amplifies
that in the window's weakly observed directions.  Accumulated once, the
grids are those of the single step wherever the per-pair blocks are (on
the CPU the new window is the single step's bit for bit), and only the
photometric error is summed per shard.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from como_tpu_torch.odom.backend import gn_step as gs
from como_tpu_torch.odom.window import WindowDims, WindowState
from como_tpu_torch.ops.reduce import reduce_in_order
from como_tpu_torch.utils.profiling import RECORDER


def make_mesh(devices=None) -> list:
    """One torch.device per shard; by default every visible CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass the mesh's devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def photo_over_shards(mesh, state, sc, dn, pairs_ref, pairs_tgt, pairs_valid, K_intr,
                      dims: WindowDims, sigmas):
    """gn_step._photo with the pairs split over the mesh (steps 2-6 of the
    module doc): the six photometric outputs on the state's device, and
    the global sigma.  The pair length must be divisible by the mesh size."""
    n, P = len(mesh), pairs_ref.shape[0]
    if P % n:
        raise ValueError(f"{P} pairs do not split over a mesh of {n}")
    home = state.P_lm.device
    occl = sigmas.occlusion_thresh
    fields, sc_in, dn_in = gs.photo_inputs(state, sc, dn, occl)
    b = P // n
    parts = []
    for s, dev in enumerate(mesh):
        blk = slice(s * b, (s + 1) * b)
        st_s = SimpleNamespace(**{k: v.to(dev) for k, v in fields.items()})
        pairs = (a[blk].to(dev) for a in (pairs_ref, pairs_tgt, pairs_valid))
        parts.append(gs._photo_residual(
            st_s, {k: v.to(dev) for k, v in sc_in.items()},
            {k: v.to(dev) for k, v in dn_in.items()}, *pairs, K_intr.to(dev), dims, occl))
    sigma = gs.photo_sigma(parts, home)
    outs = [gs._photo_pair_blocks(p, sigma.to(dev), K_intr.to(dev), dims,
                                  sigmas.estimate_affine)
            for p, dev in zip(parts, mesh)]
    blocks = {k: torch.cat([o[k].to(home) for o in outs]) for k in gs.PAIR_BLOCK_KEYS}
    blocks["photo_err"] = reduce_in_order(torch.add, [o["photo_err"] for o in outs], home)
    return gs._photo_grids(blocks, dims), sigma


def make_sharded_gn_step(mesh, dims: WindowDims, sigmas, damping: float = 1e-6):
    """Returns step(state, pairs_ref, pairs_tgt, pairs_valid, K_intr,
    damp=damping) -> (state, GNStats), the GN step with the photometric
    pairs split over the mesh.  damp is a run-time argument, as the
    product's adaptive damping needs.  The pair length must be divisible
    by the mesh size (pad with invalid pairs)."""

    def step(state: WindowState, pairs_ref, pairs_tgt, pairs_valid, K_intr, damp=damping):
        with RECORDER.span("gn.step", shards=len(mesh)):
            sc = gs._scaffold(state, K_intr, dims, sigmas.far_depth_ratio)
            state = state.replace(P_lm=sc["P_lm_new"])
            dn = gs._dense_points(state, sc, K_intr, dims)
            photo, _ = photo_over_shards(mesh, state, sc, dn, pairs_ref, pairs_tgt,
                                         pairs_valid, K_intr, dims, sigmas)
            RECORDER.count("gn.steps")
            return gs._finish(state, sc, dn, photo, K_intr, dims, sigmas, damp)

    return step
