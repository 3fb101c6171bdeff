"""The LSTM recurrence as a hand-written Hopper kernel.

Counterpart of pyannote_audio_tpu/ops/pallas_lstm.py: the CUDA kernel in
``csrc/lstm_recurrence.cu`` runs one bidirectional layer's recurrence in
one launch, in the JAX package's three precisions of the recurrent
product (see the source for its design). A CPU tensor takes the plain
PyTorch version (``ops.lstm``); a CUDA tensor launches the kernel or
raises — there is no fallback.

Up to H = 256 the kernel keeps W_hh on chip for all T steps, laid out by
``prepare_recurrent_weights`` (plain torch, testable on the CPU): gate
rows permuted and cut among the CTAs of a cluster, and for the bf16
modes ordered as ``mma.sync`` A fragments. Above H = 256 W_hh does not fit
on chip and the kernel takes its streamed route: W_hh is packed in chunks
of k-steps, each CTA keeps what fits of its share in shared memory and
streams the rest through a ring fed by bulk copies every step; the
cluster (8 or 16 CTAs) and the batch rows per cluster follow H and B
(``kernel_geometry``), and "highest" runs as three TF32 passes on tensor
cores. h takes a CTA's shared memory beside the ring, which caps H at
STREAM_MAX_HIDDEN.

``LSTMRecurrence`` makes the recurrence trainable as the JAX package's
``custom_vjp`` wrappers do (``pallas_lstm.py:212-257``): its forward is
the kernel, its backward ``lstm_recurrence_backward``, the float32
vector-Jacobian product that the JAX package takes of its scan. On a
CUDA device that is a second hand-written kernel,
``csrc/lstm_recurrence_backward.cu``: in one launch it recomputes the
layer at "highest" into a workspace of gate activations and cell states,
then walks it in reverse for the gradient of xw, both products on tensor
cores in three TF32 passes; one float32 product gives W_hh's gradient.
Its weights are packed by ``pack_backward_weights`` for the geometry
that ``backward_geometry`` chooses from H and B; above H = 256 it takes
a streamed route of the same kind (W_hh's fragments through a ring of
bulk copies, clusters of 8 or 16 CTAs, rows from B; H up to
BACKWARD_STREAM_MAX_HIDDEN). On the CPU both are their plain versions
(``ops.lstm``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.runtime import LSTM_PRECISIONS, exact_float32, lstm_precision
from .lstm import (lstm_bidirectional_recurrence_backward_plain,
                   lstm_bidirectional_recurrence_plain, split_bf16)

MAX_HIDDEN = 256          # the largest H kept on chip (kMaxHidden)
SHARED_BYTES = 227 * 1024  # shared memory a Hopper block can use
ROWS = 8                  # batch rows per cluster: the mma's n
STAGES = 6                # xw ring depth in the csrc kernel (kStages)
MAX_UNITS = 64            # hidden units per CTA (kMaxUnits): 4 warps
MODES = {"default": 0, "high": 1, "highest": 2}
SMS = 132                 # streaming multiprocessors of an H100 SXM
BACKWARD_ROWS = (8, 16, 32, 64)  # batch rows per cluster of the backward
BACKWARD_SLOTS = 8        # partial dh_rec sums a backward CTA receives
STREAM_CLUSTERS = (8, 16)  # CTAs of a cluster on the streamed routes
STREAM_PAD = 128          # H is padded to a multiple of this (16 x 8)
STREAM_ROWS = tuple(range(8, 65, 8))  # batch rows per cluster, forward
# the most consumer warps of a streamed forward CTA by row tiles a warp
# (``stream_warps`` in the source: with the producer, warps in fours)
STREAM_WARPS = {1: 15, 2: 11, 3: 11, 4: 7}
STREAM_CHUNK_BYTES = 16384  # a chunk of W_hh a CTA of a cluster of 8 reads
STREAM_SLOTS = 3          # forward ring slots where the share does not fit
STREAM_PER_SLOT = 3       # the most chunks a forward ring slot carries
BACKWARD_STREAM_SLOTS = 2  # the backward's (chunks twice the size)
RECORD = 512              # one mma fragment of a warp: 32 lanes x 16 bytes
# streamed clusters an H100 SXM holds at once, by cluster size, at one CTA
# an SM (``stream_cluster_capacity`` reads it from the card)
STREAM_CLUSTER_CAPACITY = {8: 15, 16: 7}
# the largest H of the streamed routes: above, h of every unit beside the
# ring (forward) or the phase buffers (backward) exceed a CTA's shared
# memory (``kernel_geometry``, ``backward_geometry``)
STREAM_MAX_HIDDEN = {"default": 1792, "high": 1408, "highest": 1408}
BACKWARD_STREAM_MAX_HIDDEN = 2048


def _memoised(geometry):
    """``geometry`` computed once for each set of arguments (a launch asks
    for it on every call); each call gets its own copy of the dict."""
    cached = functools.lru_cache(maxsize=None)(geometry)

    @functools.wraps(geometry)
    def wrapper(*args, **kwargs) -> dict:
        return dict(cached(*args, **kwargs))

    return wrapper


def _smallest_cluster(hidden: int, shared_bytes) -> dict:
    """The smallest cluster (1, 2, 4 or 8 CTAs; from 2 at H = 17 on, to
    spread the product over more SMs) whose CTAs each own ``padded //
    cluster`` hidden units (a multiple of 16, at most MAX_UNITS) in
    ``shared_bytes(units, padded)`` bytes of shared memory, at most
    SHARED_BYTES: {"cluster", "padded", "shared_bytes"}. Raises
    ``ValueError`` above MAX_HIDDEN."""
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} is outside what the LSTM "
                         f"kernel keeps on chip (1 to {MAX_HIDDEN})")
    for cluster in ((1, 2, 4, 8) if hidden <= 16 else (2, 4, 8)):
        padded = -(-hidden // (16 * cluster)) * 16 * cluster
        units = padded // cluster
        shared = shared_bytes(units, padded)
        if units <= MAX_UNITS and shared <= SHARED_BYTES:
            return {"cluster": cluster, "padded": padded,
                    "shared_bytes": shared}
    raise AssertionError("unreachable: H <= MAX_HIDDEN fits a cluster of 8")


def stream_layout(hidden: int, precision: str) -> dict:
    """How ``prepare_recurrent_weights`` packs W_hh for the streamed
    forward (H > MAX_HIDDEN), whatever the cluster and the batch: H padded
    to ``padded`` (a multiple of 128) units, ``steps`` k-steps of 16
    columns (ceil(H / 16); the columns past H are zero and not read), each
    (unit group of 16, k-step) ``step_bytes`` of fragment records (4 gates
    x ``parts``), and ``chunks`` chunks of ``chunk_steps`` k-steps (the
    last may hold fewer), sized so that a CTA of a cluster of 8 reads
    about STREAM_CHUNK_BYTES of each."""
    padded = -(-hidden // STREAM_PAD) * STREAM_PAD
    steps = -(-hidden // 16)
    parts = 1 if precision == "default" else 2
    step_bytes = 4 * parts * RECORD
    chunk_steps = min(steps, max(1, STREAM_CHUNK_BYTES
                                 // (padded // 128 * step_bytes)))
    return {"padded": padded, "steps": steps, "parts": parts,
            "step_bytes": step_bytes, "chunk_steps": chunk_steps,
            "chunks": -(-steps // chunk_steps)}


def _stream_candidate(layout: dict, precision: str, cluster: int,
                      rows: int, batch: int, directions: int):
    """The streamed forward at ``cluster`` CTAs and ``rows`` batch rows per
    cluster, or None where it does not fit: warps, shared memory (h's two
    parities, the k-parts' partial products, the resident chunks, the ring
    and the mbarriers, as ``stream_shared_bytes`` in the source) and what
    decides the choice. Where the (unit group, row group) warps are few,
    ``kparts`` of them split the chunks (K) among them, as many as the
    registers allow (up to 4), for the latency of each warp's chain of
    products to overlap."""
    padded = layout["padded"]
    if padded % (16 * cluster):
        return None
    units = padded // cluster
    groups, tiles = units // 16, rows // 8
    # the fewest row tiles a warp (the most warps) that the warps allow
    ntw = next((n for n in STREAM_WARPS if tiles % n == 0
                and groups * tiles // n <= STREAM_WARPS[n]), None)
    if ntw is None:
        return None
    group = groups * tiles // ntw
    kparts = max(k for k in (1, 2, 3, 4) if group * k <= STREAM_WARPS[ntw])
    warps = group * kparts
    red_bytes = (kparts - 1) * group * 16 * ntw * 32 * 4
    if precision == "highest":
        h_bytes = rows * padded * 4
    else:
        h_bytes = (2 if precision == "high" else 1) * rows * padded * 2
    chunk = groups * layout["chunk_steps"] * layout["step_bytes"]
    chunks = layout["chunks"]

    def shared(resident, slots, per_slot):
        return 2 * h_bytes + red_bytes \
            + (resident + slots * per_slot) * chunk + (3 + 2 * slots) * 8

    fit = (SHARED_BYTES - shared(0, 0, 1)) // chunk
    per_slot = 1
    if fit >= chunks:
        resident, slots = chunks, 0
    else:
        # up to STREAM_SLOTS slots of the most chunks (up to
        # STREAM_PER_SLOT) of which 2 slots fit; the rest of the room
        # resident
        per_slot = max(1, min(STREAM_PER_SLOT, fit // 2))
        slots = min(STREAM_SLOTS, fit // per_slot)
        resident = min(chunks - 1, fit - slots * per_slot)
        while resident > 0 and shared(resident, slots, per_slot) \
                > SHARED_BYTES:
            resident -= 1
        if slots < 2 or shared(resident, slots, per_slot) > SHARED_BYTES:
            return None
    clusters = directions * -(-batch // rows)
    waves = -(-clusters // STREAM_CLUSTER_CAPACITY[cluster])
    streamed = (chunks - resident) * chunk
    return {"cluster": cluster, "padded": padded,
            "shared_bytes": shared(resident, slots, per_slot),
            "stream": True,
            "units": units, "rows": rows, "ntw": ntw, "kparts": kparts,
            "warps": warps,
            "threads": 32 * (warps + 1), "steps": layout["steps"],
            "chunk_steps": layout["chunk_steps"], "chunks": chunks,
            "chunk_bytes": chunk, "resident": resident, "slots": slots,
            "per_slot": per_slot,
            "streamed_bytes": streamed, "clusters": clusters,
            "waves": waves,
            "cost": (waves, units * rows, streamed, -cluster)}


@_memoised
def kernel_geometry(hidden: int, precision: str, batch: int = 1,
                    directions: int = 2) -> dict:
    """The route and geometry the kernel runs ``hidden`` units at, for
    ``batch`` rows and ``directions``: {"cluster", "padded",
    "shared_bytes", "stream", ...}.

    Up to MAX_HIDDEN each CTA keeps the 4 gate rows of W_hh of its units
    (a warp per 16) in shared memory beside the xw ring and the
    double-buffered h (``_smallest_cluster``; "stream" False; the batch
    does not matter). Above, the streamed route ("stream" True): a
    cluster of 8 or 16 CTAs (16 only where H pads to the same ``padded``)
    of ``units`` each, ``rows`` batch rows per cluster, ``warps`` consumer
    warps of ``ntw`` row tiles in ``kparts`` k-parts and one producer warp
    (``threads``); of each CTA's share of W_hh, ``resident`` of the
    ``chunks`` chunks stay in shared memory and the rest pass through a
    ring of ``slots`` slots of ``per_slot`` chunks (``streamed_bytes`` a
    step). Among the geometries that fit, the one with the fewest
    ``waves`` (each repeats all T steps: one wherever B allows), then the
    least work a CTA (units x rows), then the fewest bytes streamed a
    step, then the larger cluster. Raises ``ValueError`` for H < 1 and
    above STREAM_MAX_HIDDEN[precision].
    """
    if precision not in MODES:
        raise ValueError(f"unknown LSTM precision {precision!r}: expected "
                         f"one of {LSTM_PRECISIONS}")

    def shared_bytes(units, padded):
        if precision == "highest":
            w_bytes = 4 * units * padded * 4
            h_bytes = 2 * padded * ROWS * 4
        else:
            parts = 2 if precision == "high" else 1
            w_bytes = parts * 4 * units * padded * 2
            h_bytes = parts * 2 * ROWS * (padded + 8) * 2
        ring_bytes = STAGES * ROWS * (4 * units + 4) * 4
        # + 2 mbarriers
        return w_bytes + h_bytes + ring_bytes + 16

    if hidden <= MAX_HIDDEN:
        return {**_smallest_cluster(hidden, shared_bytes), "stream": False}
    if hidden > STREAM_MAX_HIDDEN[precision]:
        raise ValueError(
            f"hidden size {hidden} is above what the LSTM kernel's streamed "
            f"route holds at {precision!r} (up to "
            f"{STREAM_MAX_HIDDEN[precision]}): h of every unit beside the "
            f"ring of W_hh exceeds a CTA's {SHARED_BYTES} bytes")
    layout = stream_layout(hidden, precision)
    candidates = [c for c in (_stream_candidate(layout, precision, cluster,
                                                rows, max(batch, 1),
                                                directions)
                              for cluster in STREAM_CLUSTERS
                              for rows in STREAM_ROWS) if c is not None]
    if not candidates:
        raise AssertionError(f"no streamed geometry fits H = {hidden} at "
                             f"{precision!r}")
    best = min(candidates, key=lambda c: c["cost"])
    return {k: v for k, v in best.items() if k != "cost"}


BACKWARD_CHUNK_FRAGS = (12, 8, 4, 2)  # k-steps of a backward chunk
BACKWARD_STREAM_WARPS = (16, 12)  # warps of a streamed backward CTA
BACKWARD_STREAM_CELLS = 2048  # units x rows a streamed backward CTA holds


def _backward_stream_candidate(hidden: int, cluster: int, rows: int,
                               batch: int, directions: int,
                               frags: Optional[int] = None,
                               warps: Optional[int] = None):
    """The streamed backward at ``cluster`` CTAs and ``rows`` batch rows
    per cluster, or None where it does not fit (as
    ``lstm_recurrence_backward``'s entry checks it): ``warps`` (16, or 12
    where rounds of 12 leave fewer of the phases' virtual warps idle), and
    chunks of ``frags`` k-steps of that many virtual warps, the most of
    BACKWARD_CHUNK_FRAGS that divide both phases' k-steps and of which 2
    slots fit beside the phase buffers (or as given): the warps meet at
    every chunk, so the fewer chunks the better."""
    padded = -(-hidden // STREAM_PAD) * STREAM_PAD
    units = padded // cluster
    if padded % (16 * cluster) or units * rows > BACKWARD_STREAM_CELLS:
        return None
    # (virtual warps, fragments each) of the recompute and of the walk
    phases = ((units // 2, padded // 16), (padded // 16, units // 2))
    if warps is None:
        warps = min(BACKWARD_STREAM_WARPS, key=lambda w: (sum(
            -(-vw // w) * w - vw for vw, _ in phases), -w))
    if frags is None:
        return next((c for c in (_backward_stream_candidate(
            hidden, cluster, rows, batch, directions, f, warps)
            for f in BACKWARD_CHUNK_FRAGS) if c is not None), None)
    if any(fr % frags for _, fr in phases):
        return None
    chunk_bytes = warps * frags * RECORD
    gate_row = 4 * units + 4
    buffers = max(2 * rows * (padded + 4) + 2 * rows * gate_row,
                  2 * cluster * units * (rows + 2) + rows * gate_row)
    chunks = max(-(-vw // warps) * (fr // frags) for vw, fr in phases)

    def shared(resident, ring):
        return 4 * buffers + (resident + ring) * chunk_bytes \
            + (5 + 2 * ring) * 8

    fit = (SHARED_BYTES - shared(0, 0)) // chunk_bytes
    if fit >= chunks:
        resident, ring = chunks, 0
    else:
        ring = min(BACKWARD_STREAM_SLOTS, fit)
        resident = fit - ring
        while resident > 0 and shared(resident, ring) > SHARED_BYTES:
            resident -= 1
        if ring < 2 or shared(resident, ring) > SHARED_BYTES:
            return None
    clusters = directions * -(-batch // rows)
    waves = -(-clusters // STREAM_CLUSTER_CAPACITY[cluster])
    return {"cluster": cluster, "padded": padded, "units": units,
            "rows": rows, "warps": units // 2,
            "threads": 32 * warps, "stream_warps": warps,
            "frags": padded // 16, "a_registers": 0,
            "shared_bytes": shared(resident, ring), "stream": True,
            "chunks": chunks, "resident": resident, "ring": ring,
            "frags_per_chunk": frags, "clusters": clusters, "waves": waves,
            "cost": (waves, units * rows,
                     max(0, chunks - resident) * chunk_bytes, -cluster)}


@_memoised
def backward_geometry(hidden: int, batch: int = 1,
                      directions: int = 2) -> dict:
    """The backward kernel's geometry for ``hidden`` units, ``batch`` rows
    and ``directions`` (``csrc/lstm_recurrence_backward.cu``).

    Each CTA owns ``units`` hidden units: 16 up to H = 128, in a cluster
    of the smallest power of two that covers H, with 8 warps; 32 up to
    MAX_HIDDEN (a cluster of 8, 16 warps). A warp keeps ``frags`` =
    padded / 16 mma A fragments of W_hh, split into TF32 hi and lo: in
    ``a_registers`` registers a thread at 16 units, in shared memory at
    32. ``rows``, the batch rows per cluster, is the smallest of
    BACKWARD_ROWS whose grid of one CTA per SM fits the card's SMS at once
    (latency sets the time), else the largest (fewer waves); 8 at 32
    units. Above MAX_HIDDEN the streamed route ("stream" True): a cluster
    of 8 or 16 CTAs (16 only where H pads to the same ``padded``, a
    multiple of 128) of padded / cluster units, 8 or 16 rows (units x rows
    at most BACKWARD_STREAM_CELLS), ``stream_warps`` warps (16 or 12)
    taking the packing's virtual warps in rounds (``threads``); of each
    phase's ``chunks`` chunks (of ``frags_per_chunk`` k-steps) of W_hh's
    fragments, ``resident`` stay in shared memory and the rest pass
    through a ring of ``ring`` slots, refilled by the last warp out; the
    fewest waves, then the least work a CTA (units x rows), then the
    fewest bytes streamed, then the larger cluster. ``shared_bytes`` is
    the kernel's dynamic shared memory: the larger phase's buffers plus A
    in shared memory (on chip) or the resident chunks and the ring
    (streamed) and the mbarriers. Raises ``ValueError`` for H < 1 and
    above BACKWARD_STREAM_MAX_HIDDEN.
    """
    if not 1 <= hidden <= BACKWARD_STREAM_MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} is outside what the LSTM "
                         f"backward kernel takes (1 to "
                         f"{BACKWARD_STREAM_MAX_HIDDEN}: above, its phase "
                         f"buffers exceed a CTA's shared memory)")
    if hidden > MAX_HIDDEN:
        candidates = [c for c in (
            _backward_stream_candidate(hidden, cluster, rows, max(batch, 1),
                                       directions)
            for cluster in STREAM_CLUSTERS for rows in (8, 16))
            if c is not None]
        if not candidates:
            raise AssertionError(f"no streamed backward geometry fits H = "
                                 f"{hidden}")
        best = min(candidates, key=lambda c: c["cost"])
        return {k: v for k, v in best.items() if k != "cost"}
    if hidden <= 128:
        units = 16
        cluster = 1 << max(0, (-(-hidden // 16) - 1).bit_length())
        rows = next((r for r in BACKWARD_ROWS
                     if directions * -(-batch // r) * cluster <= SMS),
                    BACKWARD_ROWS[-1])
    else:
        units, cluster, rows = 32, 8, 8
    padded = units * cluster
    warps = units // 2
    frags = padded // 16
    gate_row = 4 * units + 4
    buffers = max(2 * rows * (padded + 4) + 2 * rows * gate_row,
                  2 * BACKWARD_SLOTS * units * (rows + 2) + rows * gate_row)
    a_shared = 0 if units == 16 else warps * frags * 32 * 16
    return {"cluster": cluster, "padded": padded, "units": units,
            "rows": rows, "warps": warps, "threads": 32 * warps,
            "frags": frags, "a_registers": 8 * frags if units == 16 else 0,
            "shared_bytes": a_shared + 4 * buffers + 4 * 8,
            "stream": False, "resident": 0, "ring": 0, "frags_per_chunk": 0,
            "stream_warps": 0}


@dataclass(frozen=True)
class RecurrentWeights:
    """W_hh (D, 4H, H) laid out for the kernel at one precision.

    On chip (H <= MAX_HIDDEN) ``packed`` is (D, cluster, ...) with each
    CTA's block contiguous: float32 rows for "highest"; bf16 mma A
    fragments for "default", and hi then lo fragments for "high". Streamed
    (``cluster`` 0: the launch chooses it from B), ``packed`` is (D, n) in
    chunks of ``stream_layout``.
    """
    packed: torch.Tensor
    precision: str
    hidden: int
    cluster: int
    padded: int


def _stream_packing(w_hh: torch.Tensor, precision: str) -> torch.Tensor:
    """(D, 4H, H) W_hh -> (D, n): the streamed forward's chunks.

    Chunk j holds k-steps [j KS, j KS + ks) of every unit group of 16 in
    turn ([unit group][k-step][gate][part][lane]): unit group G's records
    of k-step s are the 4 gates' mma A fragments of units 16 G + 8 rh + g
    (fragment row g + 8 rh) by columns 16 s .., lane 4 g + t. "default" and
    "high" hold bf16 m16n8k16 fragments (16 bytes a lane: registers kh * 2
    + rh, each 2 columns 16 s + 8 kh + 2 t + e; "high" its hi then lo),
    "highest" float32 m16n8k8 fragments of the k-step's two halves (part
    = half: registers ch * 2 + rh, column 16 s + 8 half + 4 ch + t)."""
    D, H4, H = w_hh.shape
    layout = stream_layout(H, precision)
    Hp, S, KS = layout["padded"], layout["steps"], layout["chunk_steps"]
    groups = Hp // 16
    w = F.pad(w_hh.float().reshape(D, 4, H, H), (0, 16 * S - H, 0, Hp - H))
    if precision == "highest":
        # (D, gate, group, rh, g, s, half, ch, t)
        #   -> (D, group, s, gate, half, g, t, ch, rh)
        x = w.reshape(D, 4, groups, 2, 8, S, 2, 2, 4) \
            .permute(0, 2, 5, 1, 6, 4, 8, 7, 3)
    else:
        parts = split_bf16(w) if precision == "high" else (w,)
        # (D, gate, group, rh, g, s, kh, t, e)
        #   -> (D, group, s, gate, part, g, t, kh, rh, e)
        x = torch.stack([
            p.reshape(D, 4, groups, 2, 8, S, 2, 4, 2)
            .permute(0, 2, 5, 1, 4, 7, 6, 3, 8) for p in parts],
            dim=4).to(torch.bfloat16)
    return torch.cat([x[:, :, j:j + KS].reshape(D, -1)
                      for j in range(0, S, KS)], dim=1).contiguous()


def prepare_recurrent_weights(w_hh: torch.Tensor,
                              precision: str) -> RecurrentWeights:
    """Permute, pad and split (D, 4H, H) W_hh for the kernel.

    On chip, hidden units are padded to ``padded`` with zero rows and
    columns and cut into cluster x groups x 16; within a group's 16 units,
    unit ``half * 8 + g`` is fragment row ``g`` (half 0) or ``g + 8`` (half
    1), for lane group ``g`` = lane / 4. Each of the 4 gates is its own m16
    tile, so a thread's accumulators hold i, f, g and o of the same (unit,
    batch row) and the gate math needs no exchange. Streamed, the same
    fragments in chunks (``_stream_packing``).
    """
    D, H4, H = w_hh.shape
    geometry = kernel_geometry(H, precision)
    if geometry["stream"]:
        return RecurrentWeights(_stream_packing(w_hh, precision), precision,
                                H, 0, geometry["padded"])
    C, Hp = geometry["cluster"], geometry["padded"]
    groups = Hp // C // 16
    w = F.pad(w_hh.float().reshape(D, 4, H, H), (0, Hp - H, 0, Hp - H))
    if precision == "highest":
        # (D, gate, C, group, half, g, k/4, 4)
        #   -> (D, C, group, gate, k/4, half, g, 4): float4 rows along k
        packed = w.reshape(D, 4, C, groups, 2, 8, Hp // 4, 4) \
            .permute(0, 2, 3, 1, 6, 4, 5, 7)
    else:
        parts = split_bf16(w) if precision == "high" else (w,)
        # (D, gate, C, group, rh, g, k-step, kh, t, e)
        #   -> (D, C, group, gate, k-step, g, t, kh, rh, e): each lane's
        # 16 bytes are its 4 A registers {row g / g+8, k 2t(+8) .. +1}
        packed = torch.stack([
            p.reshape(D, 4, C, groups, 2, 8, Hp // 16, 2, 4, 2)
            .permute(0, 2, 3, 1, 6, 5, 8, 7, 4, 9) for p in parts],
            dim=2).to(torch.bfloat16)
    return RecurrentWeights(packed.contiguous(), precision, H, C, Hp)


def pack_backward_weights(w_hh: torch.Tensor,
                          geometry: dict) -> torch.Tensor:
    """(D, 4H, H) W_hh -> the backward kernel's mma A fragments for
    ``geometry`` (``backward_geometry``): on chip (D, cluster, 2, warps,
    frags, 32, 4) float32; streamed (D, cluster, 2, n), each phase's
    fragments in chunks.

    Hidden units are padded with zero rows and columns. CTA c of the
    cluster owns units [c * units, (c + 1) * units) and their 4 gate
    rows, A = rows ``q * units + ul`` (gate q of unit ``c * units + ul``)
    of W_hh by its ``padded`` columns: phase 0 (the recompute) multiplies
    by A, phase 1 (the walk) by A's transpose. A matrix of M x K is cut
    into 16 x 8 tiles; a lane (g = lane / 4, t = lane % 4) holds (A[g, t],
    A[g + 8, t], A[g, t + 4], A[g + 8, t + 4]) of each tile, mma.sync
    m16n8k8's A fragment; virtual warp ``kp * (M / 16) + mt`` holds tile
    row mt and its k-part kp of ``frags`` k-steps: on chip ``frags`` =
    padded / 16 in both phases (phase 0's two K halves); streamed, phase 0
    as on chip and phase 1 one k-part (all 4 * units columns, units / 2
    k-steps) for each of the padded / 16 tiles. Streamed, each phase's
    fragments are chunks of ``frags_per_chunk`` k-steps of a round of
    ``stream_warps`` virtual warps ([round][k-slice][virtual warp of the
    round][k-step][lane]), in the order the kernel reads them. The
    kernel splits each value into TF32 hi and lo
    (``ops.lstm.split_tf32``).
    """
    D, H4, H = w_hh.shape
    C, Hp, units = geometry["cluster"], geometry["padded"], geometry["units"]
    w = F.pad(w_hh.float().reshape(D, 4, H, H), (0, Hp - H, 0, Hp - H))
    # (D, gate, C, ul, k) -> (D, C, gate * units + ul, k)
    a = w.reshape(D, 4, C, units, Hp).permute(0, 2, 1, 3, 4) \
        .reshape(D, C, 4 * units, Hp)

    def fragments(m: torch.Tensor, frags: int) -> torch.Tensor:
        M, K = m.shape[2:]
        tiles, steps = M // 16, K // 8
        # (mt, row half, g, k-step, col half, t) -> (mt, k-step, g, t,
        # col half, row half): a lane's 4 values in fragment order
        x = m.reshape(D, C, tiles, 2, 8, steps, 2, 4) \
            .permute(0, 1, 2, 5, 4, 7, 6, 3).reshape(D, C, tiles, steps,
                                                     32, 4)
        # k-step kp * frags + i of tile mt -> warp kp * tiles + mt, frag i
        x = x.reshape(D, C, tiles, steps // frags, frags, 32, 4) \
            .permute(0, 1, 3, 2, 4, 5, 6)
        return x.reshape(D, C, tiles * (steps // frags), frags, 32, 4)

    if not geometry["stream"]:
        frags = geometry["frags"]
        return torch.stack([fragments(a, frags),
                            fragments(a.transpose(2, 3), frags)],
                           dim=2).contiguous()

    def chunked(x: torch.Tensor) -> torch.Tensor:
        # (virtual warp, k-step) -> [round][k-slice][warp of the round]
        # [k-step of the slice]: the full rounds in one permute, the last
        # (fewer warps) in another
        vwarps, frags = x.shape[2:4]
        W, FC = geometry["stream_warps"], geometry["frags_per_chunk"]
        full = vwarps // W * W
        runs = []
        for first, n, rounds in ((0, W, full // W),
                                 (full, vwarps - full, 1)):
            if n and rounds:
                runs.append(x[:, :, first:first + n * rounds]
                            .reshape(D, C, rounds, n, frags // FC, FC, 32, 4)
                            .permute(0, 1, 2, 4, 3, 5, 6, 7)
                            .reshape(D, C, -1))
        return torch.cat(runs, dim=2)

    return torch.stack([chunked(fragments(a, Hp // 16)),
                        chunked(fragments(a.transpose(2, 3), units // 2))],
                       dim=2).contiguous()


def _bind(name: str, pointers: int, ints: int) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library; its entry ``name`` takes
    ``pointers`` pointers, ``ints`` ints and the stream, and returns an
    int."""
    from ..utils.build import load
    lib = load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    return _bind("lstm_recurrence", 3, 13)


def _backward_library() -> ctypes.CDLL:
    return _bind("lstm_recurrence_backward", 6, 11)


def lstm_bidirectional_recurrence(
        xw: torch.Tensor, w_hh: torch.Tensor,
        precision: Optional[str] = None,
        prepared: Optional[RecurrentWeights] = None) -> torch.Tensor:
    """(T, B, D*4H) hoisted inputs + (D, 4H, H) weights -> (T, B, D*H).

    D is 1 or 2 directions; direction 1 walks time backwards.
    ``precision`` is "default", "high" or "highest"; None resolves it for
    xw's device (``utils.runtime.lstm_precision``). On the CPU this is
    ``lstm_bidirectional_recurrence_plain``; on a CUDA device one kernel
    launch covers every direction, counted in ``.launches``. ``prepared``
    is ``prepare_recurrent_weights(w_hh, precision)``, for callers that
    cache it.
    """
    if precision is None:
        precision = lstm_precision(xw.device)
    if xw.device.type == "cpu" and w_hh.device.type == "cpu":
        return lstm_bidirectional_recurrence_plain(xw, w_hh, precision)
    _check_layer(xw, w_hh)
    D, H4, H = w_hh.shape
    if prepared is None:
        prepared = prepare_recurrent_weights(w_hh, precision)
    if (prepared.precision, prepared.hidden, prepared.packed.shape[0],
            prepared.packed.device) != (precision, H, D, xw.device):
        raise ValueError(f"prepared weights are for H={prepared.hidden}, "
                         f"D={prepared.packed.shape[0]}, "
                         f"{prepared.precision!r} on "
                         f"{prepared.packed.device}, not H={H}, D={D}, "
                         f"{precision!r} on {xw.device}")
    out = _launch_forward(xw, prepared)
    lstm_bidirectional_recurrence.launches += 1
    return out


lstm_bidirectional_recurrence.launches = 0


def _check_layer(xw: torch.Tensor, w_hh: torch.Tensor) -> None:
    """Raise unless xw (T, B, D*4H) and w_hh (D, 4H, H) are one float32
    LSTM layer on one CUDA device, xw contiguous."""
    if xw.device.type != "cuda" or w_hh.device != xw.device:
        raise ValueError(f"xw and w_hh must share one CUDA device, got "
                         f"{xw.device} and {w_hh.device}")
    if xw.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"the LSTM kernel takes float32, got {xw.dtype} "
                        f"and {w_hh.dtype}")
    if w_hh.dim() != 3 or xw.dim() != 3:
        raise ValueError(f"expected xw (T, B, D*4H) and w_hh (D, 4H, H), "
                         f"got {tuple(xw.shape)} and {tuple(w_hh.shape)}")
    D, H4, H = w_hh.shape
    T, B, G = xw.shape
    if D not in (1, 2) or H4 != 4 * H or G != D * H4 or min(T, B, H) < 1:
        raise ValueError(f"shapes xw {tuple(xw.shape)} and w_hh "
                         f"{tuple(w_hh.shape)} do not form an LSTM layer")
    if not xw.is_contiguous():
        raise ValueError("xw must be contiguous")


def _launch_forward(xw: torch.Tensor,
                    prepared: RecurrentWeights) -> torch.Tensor:
    """One launch of the forward kernel. Counts nothing."""
    T, B, _ = xw.shape
    D, H = prepared.packed.shape[0], prepared.hidden
    if H > MAX_HIDDEN:
        g = kernel_geometry(H, prepared.precision, B, D)
        geometry = (g["cluster"], g["rows"], g["ntw"], g["kparts"],
                    g["chunk_steps"], g["resident"], g["slots"],
                    g["per_slot"])
    else:
        geometry = (prepared.cluster, ROWS, 1, 1, 0, 0, 0, 1)
    out = torch.empty((T, B, D * H), device=xw.device, dtype=torch.float32)
    # the C entry launches on the current device
    with torch.cuda.device(xw.device):
        err = _library().lstm_recurrence(
            xw.data_ptr(), prepared.packed.data_ptr(), out.data_ptr(),
            T, B, H, D, MODES[prepared.precision], *geometry,
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence launch failed with CUDA error "
                           f"{err}")
    return out


def stream_cluster_capacity(hidden: int, precision: str, batch: int,
                            directions: int = 2) -> int:
    """How many clusters of the streamed forward's geometry for (``hidden``,
    ``precision``, ``batch``, ``directions``) the current CUDA device holds
    at once (``cudaOccupancyMaxActiveClusters``; nothing is launched)."""
    g = kernel_geometry(hidden, precision, batch, directions)
    lib = _library()
    fn = lib.lstm_recurrence_stream_clusters
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    clusters = ctypes.c_int(0)
    err = fn(batch, hidden, directions, MODES[precision], g["cluster"],
             g["rows"], g["ntw"], g["kparts"], g["chunk_steps"],
             g["resident"], g["slots"], g["per_slot"], ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"lstm_recurrence_stream_clusters failed with "
                           f"CUDA error {err}")
    return clusters.value


def _launch_backward(xw: torch.Tensor, grad_out: torch.Tensor,
                     packed: torch.Tensor, geometry: dict,
                     workspace: torch.Tensor, h_prev: torch.Tensor,
                     grad_xw: torch.Tensor, phases: int = 3) -> None:
    """One launch of the backward kernel: ``phases`` 1 recomputes the
    layer into ``workspace`` (T, B, D, 5H) and ``h_prev`` (D, T, B, H),
    2 walks them into ``grad_xw``, 3 does both. Counts nothing."""
    T, B, _ = xw.shape
    D, H = h_prev.shape[0], h_prev.shape[3]
    with torch.cuda.device(xw.device):
        err = _backward_library().lstm_recurrence_backward(
            xw.data_ptr(), grad_out.data_ptr(), packed.data_ptr(),
            workspace.data_ptr(), h_prev.data_ptr(), grad_xw.data_ptr(),
            T, B, H, D, geometry["cluster"], geometry["rows"], phases,
            geometry["resident"], geometry["ring"],
            geometry["frags_per_chunk"], geometry["stream_warps"],
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence_backward launch failed with "
                           f"CUDA error {err}")


def lstm_recurrence_backward(xw: torch.Tensor, w_hh: torch.Tensor,
                             grad_out: torch.Tensor) -> tuple:
    """(grad_xw, grad_w_hh) of ``lstm_bidirectional_recurrence`` at
    "highest" for the output's gradient ``grad_out`` (T, B, D*H).

    On the CPU this is ``lstm_bidirectional_recurrence_backward_plain``.
    On a CUDA device one launch of the backward kernel (counted in
    ``.launches``) recomputes the layer at "highest" into a (T, B, D, 5H)
    float32 workspace of gate activations and cell states and h_prev (D,
    T, B, H), the recomputed h shifted in each direction's own order
    (both freed on return), then walks them in reverse into grad_xw, for
    every direction; grad_w_hh is ``grad_w_hh_product``. A failed build
    or launch raises.
    """
    if all(t.device.type == "cpu" for t in (xw, w_hh, grad_out)):
        return lstm_bidirectional_recurrence_backward_plain(xw, w_hh,
                                                            grad_out)
    _check_layer(xw, w_hh)
    D, H4, H = w_hh.shape
    T, B, _ = xw.shape
    if (grad_out.shape != (T, B, D * H) or grad_out.device != xw.device
            or grad_out.dtype != torch.float32
            or not grad_out.is_contiguous()):
        raise ValueError(f"grad_out must be contiguous float32 "
                         f"{(T, B, D * H)} on {xw.device}, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)} on "
                         f"{grad_out.device}")
    geometry = backward_geometry(H, B, D)
    packed = pack_backward_weights(w_hh, geometry)
    workspace = torch.empty((T, B, D, 5 * H), device=xw.device,
                            dtype=torch.float32)
    h_prev = torch.empty((D, T, B, H), device=xw.device, dtype=torch.float32)
    grad_xw = torch.empty_like(xw)
    _launch_backward(xw, grad_out, packed, geometry, workspace, h_prev,
                     grad_xw)
    lstm_recurrence_backward.launches += 1
    del workspace
    return grad_xw, grad_w_hh_product(grad_xw, h_prev)


lstm_recurrence_backward.launches = 0


def grad_w_hh_product(grad_xw: torch.Tensor,
                      h_prev: torch.Tensor) -> torch.Tensor:
    """grad_W_hh (D, 4H, H) = sum over steps and rows of dgates^T h_prev,
    from grad_xw (T, B, D*4H) and h_prev (D, T, B, H): one float32 2-D
    product over T * B per direction (cuBLAS splits the long sum; 6x
    faster than one batched product over a permuted view at DPRNN's B,
    measured on an H100)."""
    D, T, B, H = h_prev.shape
    rows = grad_xw.view(T * B, D * 4 * H)
    out = grad_xw.new_empty((D, 4 * H, H))
    with exact_float32():
        for d in range(D):
            torch.mm(rows[:, d * 4 * H:(d + 1) * 4 * H].t(),
                     h_prev[d].view(T * B, H), out=out[d])
    return out


class LSTMRecurrence(torch.autograd.Function):
    """``lstm_bidirectional_recurrence`` with a gradient.

    ``LSTMRecurrence.apply(xw, w_hh, precision, prepared)``: the forward
    is ``lstm_bidirectional_recurrence`` (one counted kernel launch on a
    CUDA device, the plain version on the CPU) at ``precision``; xw must
    be contiguous and is saved for the backward as it is, with w_hh. The
    backward is ``lstm_recurrence_backward`` (the backward kernel on a
    CUDA device, counted in its own ``.launches``; the plain version on
    the CPU): the float32 vector-Jacobian product of the "highest"
    recurrence, whatever the forward's precision, as the JAX package's
    scan VJP at ``Precision.HIGHEST``.
    """

    @staticmethod
    def forward(ctx, xw, w_hh, precision=None, prepared=None):
        ctx.save_for_backward(xw, w_hh)
        return lstm_bidirectional_recurrence(xw, w_hh, precision, prepared)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        xw, w_hh = ctx.saved_tensors
        grads = lstm_recurrence_backward(xw, w_hh, grad_out.contiguous())
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad[:2])) + (None, None)
