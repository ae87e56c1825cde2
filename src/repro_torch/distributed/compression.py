"""Compression for what crosses the network: gradients and telemetry
digests.

Port of `repro.distributed.compression`. `compress_decompress` (lines
36-65) is the gradient codec: per-tensor int8 quantisation with the
scale max|g + e| / 127, rounding half to even, and EF-SGD error
feedback, the error carried to the next step; trees are flat dicts by
leaf name, as the optimizer's, and the leaves the reference stacks into
one share its scale (`groups`). `shardmap_allreduce` (lines 68-86) is
the int8-payload all-reduce over a mesh's axes: each rank quantizes with
the largest scale of the group (one MAX), the int32 levels are summed
(one SUM), and every rank dequantizes the mean; each is an all-reduce
on the mesh's sub-group of each axis, in turn.

The digests (lines 84-206) are in numpy. Each cell summarizes its
dead-reckoned telemetry into per-tier occupancy / depth / free vectors;
the digest is serialized to wire bytes (exact float32, or int8 with one
float32 scale per plane) and the `GlobalBalancer` routes only from what
survived the round trip, so the lossy mode's routing error is exactly
the codec's quantization error. The wire format is the reference's byte
for byte: the header `<4sBBiidiii` (magic ``RBTD``, version 1, mode,
cell, seq, t, n_alive, n_total, n_tiers) and three planes.
`digest_fresh` is the staleness contract: a digest is usable while
``now - digest.t <= stale_s``.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _quantize(x, scale):
    """int8 levels: round half to even, clamp to +-127."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


@torch.no_grad()
def compress_decompress(grads: Mapping[str, torch.Tensor],
                        error_state: Optional[Mapping] = None,
                        groups: Optional[Iterable[Sequence[str]]] = None
                        ) -> Tuple[Dict, Dict, Dict[str, torch.Tensor]]:
    """Per-tensor int8 quantise (with error feedback), then dequantise.
    `groups` lists the leaf names that share one scale, as the
    reference's stacked leaves do (`Model.stacked_leaves`); by default
    each leaf has its own. Returns (grads_hat in the gradients' dtypes,
    the new float32 error state, {"compression_err_sq": the sum of its
    squares})."""
    ghat, new_e, err = {}, {}, None
    for names in groups or [(k,) for k in grads]:
        gf = {k: grads[k].float() + (
            torch.zeros(grads[k].shape, dtype=torch.float32,
                        device=grads[k].device)
            if error_state is None else error_state[k]) for k in names}
        amax = torch.stack([x.abs().max() for x in gf.values()]).max()
        scale = torch.clamp(amax / 127.0, min=1e-12)
        for k, x in gf.items():
            q = _quantize(x, scale)
            deq = q.float() * scale
            ghat[k], new_e[k] = deq.to(grads[k].dtype), x - deq
            sq = new_e[k].square().sum()
            err = sq if err is None else err + sq
    return ({k: ghat[k] for k in grads}, {k: new_e[k] for k in grads},
            {"compression_err_sq": err})


@torch.no_grad()
def shardmap_allreduce(x, mesh, axes=("data",)):
    """The mean of `x` over the ranks of the mesh's `axes`, sent as int8
    levels: this rank's scale max(|x|) / 127 (at least 1e-12, in x's
    dtype), the group's largest scale (a MAX, taken in float32, which
    holds a bfloat16 scale exactly), the int8 levels summed as int32 (a
    SUM), then `sum * scale / n` in float32, cast back to x's dtype."""
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    smax = scale.float().reshape(1)
    for a in axes:
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    scale = smax[0].to(scale.dtype)
    s = _quantize(x, scale).to(torch.int32)
    n = 1
    for a in axes:
        dist.all_reduce(s, group=mesh.get_group(a))
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return (s.float() * scale / n).to(x.dtype)

_DIGEST_MAGIC = b"RBTD"
_DIGEST_VERSION = 1
DIGEST_MODES = ("exact", "int8")
# magic, version, mode, cell, seq, t, n_alive, n_total, n_tiers
_HEADER = struct.Struct("<4sBBiidiii")


@dataclasses.dataclass
class TelemetryDigest:
    """One cell's telemetry summary: per-tier occupancy (batch fill
    fraction of the alive capacity), queue depth (pending + queued work)
    and free decode slots, plus the alive roster count and the cell's
    sim-clock send time."""
    cell: int
    seq: int
    t: float
    n_alive: int
    n_total: int
    tier_occupancy: np.ndarray          # (T,) float32
    tier_depth: np.ndarray              # (T,) float32
    tier_free: np.ndarray               # (T,) float32

    @property
    def depth_total(self) -> float:
        return float(self.tier_depth.sum())

    @property
    def free_total(self) -> float:
        return float(self.tier_free.sum())

    def age(self, now: float) -> float:
        return now - self.t


def digest_fresh(d: TelemetryDigest, now: float, stale_s: float) -> bool:
    """A digest is usable while its age is within `stale_s` of the
    observer's clock; past that its cell is dark."""
    return d.age(now) <= stale_s


def digest_from_telemetry(tel, tier_of_slot: np.ndarray, n_tiers: int,
                          cell: int, seq: int, t: float
                          ) -> TelemetryDigest:
    """Summarize a telemetry view (a cell mirror or the whole array)
    into per-tier vectors. `tier_of_slot` (n,) maps each row to its tier
    index; dead and quarantined rows contribute nothing."""
    alive = np.asarray(tel.alive, bool)
    tos = np.asarray(tier_of_slot)

    def wsum(w):
        return np.bincount(tos[alive],
                           weights=np.asarray(w, np.float64)[alive],
                           minlength=n_tiers).astype(np.float32)
    cap = wsum(tel.max_batch)
    occ = wsum(tel.batch) / np.maximum(cap, 1.0)
    depth = wsum(np.asarray(tel.pending) + np.asarray(tel.queue))
    free = wsum(tel.free)
    return TelemetryDigest(cell=int(cell), seq=int(seq), t=float(t),
                           n_alive=int(alive.sum()), n_total=len(alive),
                           tier_occupancy=occ, tier_depth=depth,
                           tier_free=free)


def _encode_plane(x: np.ndarray, mode: str) -> bytes:
    x = np.asarray(x, np.float32)
    if mode == "exact":
        return x.tobytes()
    # int8: one float32 scale per plane, round half to even, clip to 127
    scale = np.float32(max(float(np.abs(x).max()) / 127.0, 1e-12))
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return struct.pack("<f", scale) + q.tobytes()


def _decode_plane(buf: bytes, off: int, n: int, mode: str
                  ) -> Tuple[np.ndarray, int]:
    if mode == "exact":
        end = off + 4 * n
        return np.frombuffer(buf[off:end], np.float32).copy(), end
    (scale,) = struct.unpack_from("<f", buf, off)
    off += 4
    end = off + n
    q = np.frombuffer(buf[off:end], np.int8)
    return q.astype(np.float32) * np.float32(scale), end


def encode_digest(d: TelemetryDigest, mode: str = "exact") -> bytes:
    """Serialize a digest. ``exact`` ships raw float32 planes (a bitwise
    round trip); ``int8`` ships a float32 scale and an int8 payload per
    plane, a quarter of the payload at <= scale/2 error per entry."""
    if mode not in DIGEST_MODES:
        raise ValueError(f"digest mode {mode!r} not in {DIGEST_MODES}")
    head = _HEADER.pack(_DIGEST_MAGIC, _DIGEST_VERSION,
                        DIGEST_MODES.index(mode), d.cell, d.seq, d.t,
                        d.n_alive, d.n_total, len(d.tier_depth))
    return head + b"".join(
        _encode_plane(p, mode)
        for p in (d.tier_occupancy, d.tier_depth, d.tier_free))


def decode_digest(buf: bytes) -> TelemetryDigest:
    magic, ver, mode_i, cell, seq, t, n_alive, n_total, T = \
        _HEADER.unpack_from(buf, 0)
    if magic != _DIGEST_MAGIC or ver != _DIGEST_VERSION:
        raise ValueError(f"not a version-{_DIGEST_VERSION} telemetry "
                         f"digest: {(magic, ver)}")
    mode = DIGEST_MODES[mode_i]
    off = _HEADER.size
    occ, off = _decode_plane(buf, off, T, mode)
    depth, off = _decode_plane(buf, off, T, mode)
    free, off = _decode_plane(buf, off, T, mode)
    return TelemetryDigest(cell=cell, seq=seq, t=t, n_alive=n_alive,
                           n_total=n_total, tier_occupancy=occ,
                           tier_depth=depth, tier_free=free)
