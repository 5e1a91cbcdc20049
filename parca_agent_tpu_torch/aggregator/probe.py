"""The hash-table kernels: CUDA kernel wrappers and plain versions.

Counterpart of parca_agent_tpu/aggregator/pallas_probe.py: the stack
dictionary's batch probe (make_batch_probe, and the probe loop inside
aggregator/dict.py:make_feed) and the one-shot window's location table
(make_loc_table_builder). Three entry points, each with a plain PyTorch
version beside it:

  batch_probe(table, h1, h2, h3) -> found_id
      up to PROBES linear-probe steps at (h1 + k) & (cap - 1) into the
      resident table; found_id = stored id on a full (h1, h2, h3) match,
      -1 on an empty-slot stop or a chain past the bound.
  feed_accumulate(table, acc, touch, blk, h1, h2, h3, cnt) -> found_id
      the probe fused with the feed's accumulate: every live row
      (cnt > 0) that hits adds cnt to acc[id] and sets touch[id // blk].
      acc and touch are updated in place.
  build_loc_table(kpid, khi, klo, base, cap_l, l_cap)
      -> (slot, epid, ehi, elo, eslot, n_entries)
      every live (kpid != U32_MAX) 96-bit key finds or claims one slot of
      an open-addressing table of cap_l slots, walking linearly from
      base & (cap_l - 1) (base None: loc_base of the key); slot = -1 for
      dead lanes and for lanes that could not place (the table is too
      small). The table's keys come back as a dense list of l_cap entries
      (key e sits in slot eslot[e]) and their count.

Dispatch is by the tensors' device, and only by it: CUDA tensors launch
the kernel of csrc/feed_probe.cu or csrc/loc_table.cu (a failed build or
launch raises), CPU tensors run the plain version. Nothing falls back.

u32 lanes: the table and the hash lanes are uint32 values carried in int32
tensors bit for bit (a numpy uint32 array viewed as int32 on the way in);
equality on those bits is u32 equality, and the one piece of u32
arithmetic (the probe index) widens to int64 and masks to 32 bits.
"""

from __future__ import annotations

import torch

from parca_agent_tpu_torch.ops import kernels
from parca_agent_tpu_torch.ops.hashing import hash_params, multilinear_hash_u32

# Linear-probe bound (csrc/feed_probe.cu kProbes; the JAX package's _PROBES).
PROBES = 16
_U32 = 0xFFFFFFFF
# The location table's probe base: the first three coefficients of hash
# family 3 and its bias (csrc/loc_table.cu hashes [pid, hi, lo] with them).
_LOC_COEFS, _LOC_BIASES = hash_params(4, 0)

# Kernel launches per entry point: each wrapper adds one where it launches
# its CUDA kernel and nowhere else (the plain version counts nothing).
LAUNCHES = {"batch_probe": 0, "feed_accumulate": 0, "loc_table": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_lanes(table, *lanes) -> None:
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[1] != 4 or not table.is_contiguous():
        raise ValueError("table must be a contiguous int32 [cap, 4] tensor "
                         "(uint32 bits)")
    cap = table.shape[0]
    if cap < 1 or cap & (cap - 1):
        raise ValueError(f"table capacity {cap} is not a power of two")
    n = lanes[0].shape[0]
    for x in lanes:
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != n \
                or not x.is_contiguous():
            raise ValueError("hash/count lanes must be contiguous int32 [n] "
                             "tensors of one length (uint32 bits)")
        if x.device != table.device:
            raise ValueError(f"lane on {x.device}, table on {table.device}")


# -- plain versions ----------------------------------------------------------


def batch_probe_plain(table: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                      h3: torch.Tensor) -> torch.Tensor:
    """The probe in plain PyTorch ops (the lax loop of make_feed, step by
    step): int32 [n] found ids."""
    mask = table.shape[0] - 1
    h1w = h1.to(torch.int64) & _U32
    found = torch.full(h1.shape, -1, dtype=torch.int32, device=h1.device)
    done = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    for k in range(PROBES):
        row = table[(h1w + k) & mask]
        occ = row[:, 3] != 0
        hit = occ & (row[:, 0] == h1) & (row[:, 1] == h2) & (row[:, 2] == h3)
        found = torch.where(hit & ~done, row[:, 3] - 1, found)
        done = done | hit | ~occ
    return found


def feed_accumulate_plain(table, acc, touch, blk: int, h1, h2, h3,
                          cnt) -> torch.Tensor:
    """Plain version of feed_accumulate (make_feed's probe + scatter-add
    + touch marking; out-of-range ids dropped like mode="drop")."""
    found = batch_probe_plain(table, h1, h2, h3)
    hit = (found >= 0) & (cnt > 0)
    ids = found[hit].to(torch.int64)
    keep = ids < acc.shape[0]
    acc.index_add_(0, ids[keep], cnt[hit][keep])
    if touch is not None:
        b = ids // blk
        touch[b[b < touch.shape[0]]] = 1
    return found


def loc_base(kpid: torch.Tensor, khi: torch.Tensor,
             klo: torch.Tensor) -> torch.Tensor:
    """The location table's probe base: hash family 3 over [pid, hi, lo]
    (int32 bits), as _window_kernel computes it."""
    return multilinear_hash_u32(torch.stack([kpid, khi, klo], dim=-1), 3)


def _dense_entries(tpid, thi, tlo, l_cap: int):
    """The table's live slots in ascending slot order as the kernel's
    dense list: (epid, ehi, elo, eslot) [l_cap], padded with (U32_MAX, 0,
    0, cap_l), and the live count as int32 [1] (may exceed l_cap)."""
    cap_l = tpid.shape[0]
    live = (tpid != -1).nonzero().squeeze(1)
    n_live = live.numel()
    k = min(n_live, l_cap)
    dev = tpid.device
    epid = torch.full((l_cap,), -1, dtype=torch.int32, device=dev)
    ehi = torch.zeros(l_cap, dtype=torch.int32, device=dev)
    elo = torch.zeros(l_cap, dtype=torch.int32, device=dev)
    eslot = torch.full((l_cap,), cap_l, dtype=torch.int32, device=dev)
    epid[:k], ehi[:k], elo[:k] = tpid[live[:k]], thi[live[:k]], tlo[live[:k]]
    eslot[:k] = live[:k].to(torch.int32)
    n_entries = torch.tensor([n_live], dtype=torch.int32, device=dev)
    return epid, ehi, elo, eslot, n_entries


def build_loc_table_plain(kpid: torch.Tensor, khi: torch.Tensor,
                          klo: torch.Tensor, base: torch.Tensor | None,
                          cap_l: int, l_cap: int):
    """The location table in plain PyTorch ops: make_loc_table_builder's
    loop, iteration for iteration, so slot and the table equal the Pallas
    kernel's bit for bit. Each iteration, every unplaced lane reads its
    slot: a match places it; on an empty slot the lowest lane that wants
    it claims it (the others re-read it next iteration); a lane advances
    only past an occupied mismatch. At most 2 * cap_l + 2 iterations.
    Placed lanes do nothing in that loop, so only the unplaced ones are
    carried from one iteration to the next. Returns build_loc_table's
    tuple: the table's live slots, in ascending slot order, as the dense
    list."""
    dev = kpid.device
    n = kpid.shape[0]
    mask = cap_l - 1
    if base is None:
        base = loc_base(kpid, khi, klo)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    # The table and the claim buffer carry a dump slot at cap_l for lanes
    # that claim nothing (the JAX scatters' mode="drop").
    tpid = torch.full((cap_l + 1,), -1, dtype=torch.int32, device=dev)
    thi = torch.zeros(cap_l + 1, dtype=torch.int32, device=dev)
    tlo = torch.zeros(cap_l + 1, dtype=torch.int32, device=dev)
    claim = torch.full((cap_l + 1,), n, dtype=torch.int64, device=dev)
    lane = (kpid != -1).nonzero().squeeze(1)
    pos = base[lane].to(torch.int64) & mask
    kp, kh, kl = kpid[lane], khi[lane], klo[lane]
    for _ in range(2 * cap_l + 2):
        if lane.numel() == 0:
            break
        occ_pid = tpid[pos]
        occ = occ_pid != -1
        match = occ & (occ_pid == kp) & (thi[pos] == kh) & (tlo[pos] == kl)
        tgt = torch.where(occ, cap_l, pos)
        claim.scatter_reduce_(0, tgt, lane, "amin")
        won = ~occ & (claim[pos] == lane)
        claim[tgt] = n
        wtgt = torch.where(won, pos, cap_l)
        tpid[wtgt] = kp
        thi[wtgt] = kh
        tlo[wtgt] = kl
        placed = match | won
        slot[lane[placed]] = pos[placed].to(torch.int32)
        pos = torch.where(occ & ~match, (pos + 1) & mask, pos)
        keep = ~placed
        lane, pos, kp, kh, kl = (x[keep] for x in (lane, pos, kp, kh, kl))
    return (slot, *_dense_entries(tpid[:cap_l], thi[:cap_l], tlo[:cap_l],
                                  l_cap))


# -- CUDA kernel wrappers ----------------------------------------------------


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def batch_probe(table: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                h3: torch.Tensor) -> torch.Tensor:
    """found_id int32 [n]; CUDA tensors launch the kernel, CPU tensors run
    batch_probe_plain."""
    _check_lanes(table, h1, h2, h3)
    if table.device.type == "cpu":
        return batch_probe_plain(table, h1, h2, h3)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    lib = kernels.load("feed_probe")
    n = h1.shape[0]
    found = torch.empty(n, dtype=torch.int32, device=table.device)
    code = lib.pa_batch_probe(
        table.data_ptr(), table.shape[0], h1.data_ptr(), h2.data_ptr(),
        h3.data_ptr(), found.data_ptr(), n, _stream_ptr(table.device))
    kernels.check_launch(lib, code, "batch_probe")
    LAUNCHES["batch_probe"] += 1
    return found


def feed_accumulate(table: torch.Tensor, acc: torch.Tensor,
                    touch: torch.Tensor | None, blk: int, h1: torch.Tensor,
                    h2: torch.Tensor, h3: torch.Tensor,
                    cnt: torch.Tensor) -> torch.Tensor:
    """found_id int32 [n], with acc (int32 [id_cap]) and touch (int32
    [n_blocks] or None) updated in place; CUDA tensors launch the fused
    kernel, CPU tensors run feed_accumulate_plain."""
    _check_lanes(table, h1, h2, h3, cnt)
    for name, t in (("acc", acc), ("touch", touch)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != table.device:
            raise ValueError(f"{name} must be a contiguous int32 [n] tensor "
                             f"on {table.device}")
    if touch is not None and blk <= 0:
        raise ValueError("touch tracking needs a block size > 0")
    if table.device.type == "cpu":
        return feed_accumulate_plain(table, acc, touch, blk, h1, h2, h3, cnt)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    lib = kernels.load("feed_probe")
    n = h1.shape[0]
    found = torch.empty(n, dtype=torch.int32, device=table.device)
    code = lib.pa_feed_accumulate(
        table.data_ptr(), table.shape[0], acc.data_ptr(), acc.shape[0],
        touch.data_ptr() if touch is not None else None,
        touch.shape[0] if touch is not None else 0, max(blk, 1),
        h1.data_ptr(), h2.data_ptr(), h3.data_ptr(), cnt.data_ptr(),
        found.data_ptr(), n, _stream_ptr(table.device))
    kernels.check_launch(lib, code, "feed_accumulate")
    LAUNCHES["feed_accumulate"] += 1
    return found


def build_loc_table(kpid: torch.Tensor, khi: torch.Tensor,
                    klo: torch.Tensor, base: torch.Tensor | None,
                    cap_l: int, l_cap: int):
    """(slot int32 [n], epid, ehi, elo, eslot int32 [l_cap], n_entries
    int32 [1]); key lanes are uint32 bits. CUDA tensors launch the kernel
    of csrc/loc_table.cu, CPU tensors run build_loc_table_plain.

    base None: each lane's probe base is loc_base of its key (the kernel
    hashes it itself). Every key the table holds is one dense entry: key
    (epid[e], ehi[e], elo[e]) sits in slot eslot[e] for e < n_entries;
    entries past it are (U32_MAX, 0, 0, cap_l), and n_entries > l_cap
    means some were dropped. The kernel claims slots by compare-and-swap,
    so a key may land in another slot, and the list come in another order,
    than the plain version gives; what both keep is one slot per distinct
    live key, each live lane's slot holding its key, the same set of
    listed keys, and a live -1 exactly when cap_l slots cannot hold every
    key."""
    n = kpid.shape[0]
    for x in (kpid, khi, klo) + (() if base is None else (base,)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != n \
                or not x.is_contiguous() or x.device != kpid.device:
            raise ValueError("key lanes must be contiguous int32 [n] tensors "
                             "of one length on one device (uint32 bits)")
    if cap_l < 1 or cap_l & (cap_l - 1) or cap_l > 1 << 31:
        raise ValueError(f"table capacity {cap_l} is not a power of two "
                         "<= 2^31")
    if l_cap < 1:
        raise ValueError(f"dense list length {l_cap} is not positive")
    dev = kpid.device
    if dev.type == "cpu":
        return build_loc_table_plain(kpid, khi, klo, base, cap_l, l_cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = kernels.load("loc_table")
    # Scratch: the table of 16-byte slot records and the entry counter,
    # both initialised by the kernel's first launch.
    table = torch.empty((cap_l, 4), dtype=torch.int32, device=dev)
    n_entries = torch.empty(1, dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    epid, ehi, elo, eslot = (torch.empty(l_cap, dtype=torch.int32,
                                         device=dev) for _ in range(4))
    c0, c1, c2 = (int(c) for c in _LOC_COEFS[3])
    code = lib.pa_loc_table(
        kpid.data_ptr(), khi.data_ptr(), klo.data_ptr(),
        None if base is None else base.data_ptr(), c0, c1, c2,
        int(_LOC_BIASES[3]), n, cap_l, table.data_ptr(),
        n_entries.data_ptr(), slot.data_ptr(), l_cap, epid.data_ptr(),
        ehi.data_ptr(), elo.data_ptr(), eslot.data_ptr(), _stream_ptr(dev))
    kernels.check_launch(lib, code, "loc_table")
    LAUNCHES["loc_table"] += 1
    return slot, epid, ehi, elo, eslot, n_entries
