"""Wrappers of the CUDA Ed25519 verification kernels (csrc/verify.cu,
csrc/poly.cu, csrc/oneshot.cu, csrc/digits.cu), the counterpart of
curve25519_tpu/ops/pallas/verify_kernel.py, and their plain versions.

- ``verify_init(pk)``: [..., 32] uint8 public keys -> (planes [..., 16, 160]
  int8, ok [...] bool): the q_table of -Q as a verify context holds it
  (models/tables.pe_planes_from_canonical), and whether the key decoded.
- ``poly_mult(u, v, planes)``: enc(s*G + h*(-Q)) [..., 32] uint8 from the
  8-fold digits u [..., 32] of s and the 4-fold digits v [..., 64] of h
  (ops/fold), against one q_table per lane (planes [..., 16, 160]) or, when
  planes.ndim == 2, one q_table for every lane (the shared kernel).
- ``verify_oneshot(pk, u, v)``: (enc(R') [..., 32] uint8, ok [...] bool),
  the two in one launch (csrc/oneshot.cu): persistent blocks, one per SM,
  each running the same rounds over its share of the lanes (whole warps of
  consecutive lanes, spread evenly over the blocks and their rounds), with
  a scratch row for the q_table of each of its threads that the launch
  alone uses. The library sizes the scratch (``oneshot_scratch_rows``) and
  takes its grid from it.
- ``key_lookup(pk, keys, index)``: (key [...] int32, order, counts) of
  public keys pk [..., 32] among K cached keys [K, 32] (``key_index(keys)``,
  their sorted 8-byte prefixes, made once per set of keys): each lane's row
  of keys or -1, the lanes ordered misses first, and {misses, hits}, all on
  the device (csrc/poly.cu's key_lookup_kernel).
- ``poly_keyed(u, v, lookup, planes, key_ok, pk)``: (enc(R') [..., 32]
  uint8, ok [...] bool) for lanes whose keys come from a known set: planes
  [K, 16, 160] and key_ok [K] are a verify context of K keys, lookup
  key_lookup's of pk; a lane keyed -1 runs Verify_Init on its own pk as
  verify_oneshot would. One launch (poly_keyed_kernel): hit lanes read their
  key's q_table by index, with no per-lane copy, and no host read sizes the
  launch.
- ``digits(md, s)``: (u [..., 32], v [..., 64]) int32, the digits that
  poly_mult and verify_oneshot read: the 8-fold digits of S's raw bytes s
  [..., 32] (not reduced) and the 4-fold digits of h = md mod l from
  SHA-512 digests md [..., 64] uint8, in one launch (csrc/digits.cu).
  ed25519.verify and verify_check launch it once a call on a card.

The multiply reads the folding-8 table as ``edwards_kernel.word_table(8)``.

The first five have a ``*_plain`` version in plain PyTorch (on
models/edwards and models/tables); CUDA tensors launch the kernels (or
raise), CPU tensors run the plain versions. ``digits`` takes CUDA tensors
only: its plain version is fold.cut8_bytes(s) and
fold.cut4_limbs(sc.from_digest(md)), which models/ed25519 calls for CPU
tensors. ``launches`` counts kernel launches
per kernel. ``oneshot_warps`` sums over one-shot launches the warps of the
busiest block (``busiest``, from the library's split) and the mean warps a
block (``mean``): mean / busiest is the share of the SMs' warp slots the
launch fills. ``cached_lanes`` tallies the lanes of poly_keyed by route,
``hit`` and ``miss``: each a tensor on the device of the last call, added
to without a sync; reading it (``int(...)``) waits for the card.
"""

import torch

from curve25519_tpu_torch.config import NLIMBS
from curve25519_tpu_torch.models import edwards, tables
from curve25519_tpu_torch.ops import fe
from curve25519_tpu_torch.ops.cuda import (
    build, edwards_kernel, flatten_batch, use_cuda,
)
from curve25519_tpu_torch.utils import profiling

__all__ = ["verify_init", "verify_init_plain", "poly_mult", "poly_mult_plain",
           "key_index", "key_lookup", "key_lookup_plain", "poly_keyed",
           "poly_keyed_plain", "verify_oneshot", "verify_oneshot_plain",
           "digits", "launches", "cached_lanes"]

QT_SHAPE = (16, 8 * NLIMBS)
ONESHOT_BLOCK = 512                    # csrc/oneshot.cu's kOneshotBlock

launches = {"verify_init": 0, "poly": 0, "poly_shared": 0, "key_lookup": 0,
            "poly_keyed": 0, "oneshot": 0, "digits": 0}
oneshot_warps = {"busiest": 0, "mean": 0.0}
cached_lanes = {"hit": 0, "miss": 0}


def verify_init_plain(pk):
    """The plain version of the Verify_Init kernel: decompress -Q, then the
    16 subset sums of {-Q, 2^64(-Q), 2^128(-Q), 2^192(-Q)} in PE form from
    192 doublings (reference ed25519_Verify_Init)."""
    q, ok = edwards.unpack_point(pk, negate=True)
    batch, dev = pk.shape[:-1], pk.device
    qt = [None] * 16
    qt[0] = {"ypx": fe.one(batch, dev), "ymx": fe.one(batch, dev),
             "t2d": fe.zero(batch, dev), "z2": fe.from_int(2, batch, dev)}
    qt[1] = edwards.to_pe(q)
    for base in (2, 4, 8):
        for _ in range(64):
            q = edwards.double(q)
        qt[base] = edwards.to_pe(q)
        for s in range(1, base):
            qt[base + s] = edwards.to_pe(edwards.add_pe(q, qt[s]))
    arr = torch.stack([torch.stack([e[k] for k in edwards_kernel.PE_KEYS], -2)
                       for e in qt], -3)               # [..., 16, 4, NLIMBS]
    return tables.pe_planes_from_array(arr), ok


def poly_mult_plain(u, v, planes):
    """The plain version of the poly kernels (either q_table route)."""
    return edwards.pack(*edwards.poly_point_mult(u, v, planes))


def verify_oneshot_plain(pk, u, v):
    """The plain version of the one-shot kernel: the two plain phases, the
    key's flag broadcast over the batch as the kernel's."""
    planes, ok = verify_init_plain(pk)
    r = poly_mult_plain(u, v, planes)
    return r, ok.expand(r.shape[:-1])


def _prefix(pk):
    """The first 8 bytes of keys pk [..., 32] as one little-endian int64
    each."""
    return pk[..., :8].contiguous().view(torch.int64)[..., 0]


def key_index(keys):
    """(prefixes [K] int64, rows [K] int32) of keys [K, 32] uint8, what
    key_lookup searches: each key's first 8 bytes as one little-endian
    int64, sorted, and the key's row of keys."""
    prefixes, rows = torch.sort(_prefix(keys))
    return prefixes, rows.to(torch.int32)


def key_lookup_plain(pk, keys, index):
    """The plain version of the lookup kernel (see key_lookup), its order
    the misses then the hits, each in lane order. It reads the longest run
    of lanes' equal prefixes on the host."""
    prefixes, rows = index
    prefix = _prefix(pk)
    first = torch.searchsorted(prefixes, prefix)
    run = torch.searchsorted(prefixes, prefix, right=True) - first
    key = torch.full(prefix.shape, -1, dtype=torch.int32, device=pk.device)
    for i in range(int(run.max()) if run.numel() else 0):
        row = rows[(first + i).clamp(max=len(rows) - 1)]
        key = torch.where((key < 0) & (run > i) & (keys[row] == pk).all(-1),
                          row, key)
    hit = key.reshape(-1) >= 0
    order = torch.sort(hit.to(torch.uint8), stable=True).indices
    hits = hit.sum()
    return key, order, torch.stack([hit.numel() - hits, hits])


def poly_keyed_plain(u, v, key, planes, key_ok, pk):
    """The plain version of the keyed kernel: each lane's q_table and flag
    are its key's row of planes and key_ok, or for key -1 Verify_Init's of
    its own pk; then the plain double-scalar multiply."""
    batch = torch.broadcast_shapes(u.shape[:-1], v.shape[:-1], key.shape,
                                   pk.shape[:-1])
    key = key.expand(batch)
    miss = key < 0
    row = key.clamp(min=0).long()
    qt, ok = planes[row], key_ok[row]
    qt[miss], ok[miss] = verify_init_plain(pk.expand(batch + (32,))[miss])
    return poly_mult_plain(u, v, qt), ok


def _check(t, name, dtype, tail):
    if t.dtype != dtype or t.ndim < len(tail) or tuple(t.shape[t.ndim - len(
            tail):]) != tail:
        raise ValueError("%s must be [..., %s] %s, got %s %s"
                         % (name, ", ".join(map(str, tail)), dtype,
                            tuple(t.shape), t.dtype))


def _same_device(*ts):
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("inputs on several devices: %s"
                         % sorted({str(t.device) for t in ts}))


def _rows(t, batch, n, tail):
    """t broadcast to batch + tail as [n, *tail] contiguous rows."""
    return t.expand(batch + tail).reshape((n,) + tail).contiguous()


def _aligned(t):
    """t itself, or a copy when its data does not start on 16 bytes (the
    kernels read q_table entries with 16-byte loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def verify_init(pk):
    """(planes [..., 16, 160] int8, ok [...] bool) of public keys pk
    [..., 32] uint8: the CUDA kernel for a CUDA pk, the plain version for a
    CPU one."""
    _check(pk, "pk", torch.uint8, (32,))
    if not use_cuda(pk):
        return verify_init_plain(pk)
    batch = pk.shape[:-1]
    n, unflatten = flatten_batch(batch)
    pk = pk.reshape(n, 32).contiguous()
    planes = torch.empty((n,) + QT_SHAPE, dtype=torch.int8, device=pk.device)
    ok = torch.empty((n,), dtype=torch.bool, device=pk.device)
    build.launch("verify", "verify_init_launch", pk.device, planes.data_ptr(),
                 ok.data_ptr(), pk.data_ptr(), n, n=n)
    launches["verify_init"] += 1
    return unflatten(planes), unflatten(ok)


def poly_mult(u, v, planes):
    """enc(s*G + h*(-Q)) [..., 32] uint8 (see the module docstring). Batch
    axes of u, v and per-lane planes broadcast."""
    _check(u, "u", torch.int32, (32,))
    _check(v, "v", torch.int32, (64,))
    _check(planes, "planes", torch.int8, QT_SHAPE)
    _same_device(u, v, planes)
    if not use_cuda(u):
        return poly_mult_plain(u, v, planes)
    shared = planes.ndim == 2
    batch = torch.broadcast_shapes(u.shape[:-1], v.shape[:-1],
                                   () if shared else planes.shape[:-2])
    n, unflatten = flatten_batch(batch)
    with profiling.span("verify_kernel.poly_rows", n):
        u, v = _rows(u, batch, n, (32,)), _rows(v, batch, n, (64,))
        planes = _aligned(planes.contiguous() if shared
                          else _rows(planes, batch, n, QT_SHAPE))
        out = torch.empty((n, 32), dtype=torch.uint8, device=u.device)
    build.launch("poly", "poly_launch", u.device, out.data_ptr(),
                 u.data_ptr(), v.data_ptr(), planes.data_ptr(), int(shared),
                 edwards_kernel.word_table(8, u.device).data_ptr(), n, n=n)
    launches["poly_shared" if shared else "poly"] += 1
    return unflatten(out)


def key_lookup(pk, keys, index):
    """(key [...] int32, order [n] int64, counts [2] int64) of public keys
    pk [..., 32] uint8 among K >= 1 cached keys [K, 32] with their
    key_index: each lane's row of keys or -1 (a lane's prefix is searched
    among the sorted prefixes, and the keys from the place found that share
    it are compared whole), the flat lanes ordered the misses first, and
    {misses, hits}. For CUDA tensors one launch of key_lookup_kernel (a
    warp takes its lanes' places in `order` in any order), which reads
    nothing on the host; for CPU tensors key_lookup_plain."""
    _check(pk, "pk", torch.uint8, (32,))
    _check(keys, "keys", torch.uint8, (32,))
    prefixes, rows = index
    if keys.ndim != 2 or not len(keys) or prefixes.dtype != torch.int64 \
            or rows.dtype != torch.int32 or prefixes.shape != keys.shape[:1] \
            or rows.shape != keys.shape[:1]:
        raise ValueError("keys must be [K, 32] uint8 with K >= 1, and their "
                         "index [K] int64 prefixes and [K] int32 rows, got "
                         "%s, %s %s and %s %s"
                         % (tuple(keys.shape), tuple(prefixes.shape),
                            prefixes.dtype, tuple(rows.shape), rows.dtype))
    _same_device(pk, keys, prefixes, rows)
    if not use_cuda(pk):
        return key_lookup_plain(pk, keys, index)
    n, unflatten = flatten_batch(pk.shape[:-1])
    dev = pk.device
    pk = pk.reshape(n, 32).contiguous()
    key = torch.empty((n,), dtype=torch.int32, device=dev)
    order = torch.empty((n,), dtype=torch.int64, device=dev)
    counts = torch.empty((2,), dtype=torch.int64, device=dev)
    build.launch("poly", "key_lookup_launch", dev, key.data_ptr(),
                 order.data_ptr(), counts.data_ptr(), pk.data_ptr(),
                 prefixes.contiguous().data_ptr(),
                 rows.contiguous().data_ptr(), keys.contiguous().data_ptr(),
                 len(keys), n, n=n)
    launches["key_lookup"] += 1
    return unflatten(key), order, counts


def _tally(counts):
    """Add a call's {misses, hits} (a tensor) to cached_lanes on its
    device, without a sync."""
    for i, name in enumerate(("miss", "hit")):
        kept = cached_lanes[name]
        if isinstance(kept, torch.Tensor):
            kept = kept.to(counts.device)
        cached_lanes[name] = counts[i] + kept


def poly_keyed(u, v, lookup, planes, key_ok, pk):
    """(enc(R') [..., 32] uint8, ok [...] bool) from a table of K keys'
    q_tables (see the module docstring), lookup = key_lookup(pk, ...): one
    launch for CUDA tensors, poly_keyed_plain for CPU ones; both add the
    lookup's counts to cached_lanes. u and v broadcast to the lookup's
    batch, pk's."""
    key, order, counts = lookup
    _check(u, "u", torch.int32, (32,))
    _check(v, "v", torch.int32, (64,))
    _check(pk, "pk", torch.uint8, (32,))
    _check(planes, "planes", torch.int8, QT_SHAPE)
    if key.dtype != torch.int32 or key.shape != pk.shape[:-1] or \
            planes.ndim != 3 or key_ok.dtype != torch.bool or \
            key_ok.shape != planes.shape[:1]:
        raise ValueError("key must be pk's [...] int32 and the table planes "
                         "[K, 16, 160] int8 with key_ok [K] bool, got %s %s, "
                         "%s and %s %s" % (key.dtype, tuple(key.shape),
                                           tuple(planes.shape),
                                           tuple(key_ok.shape), key_ok.dtype))
    _same_device(u, v, key, planes, key_ok, pk)
    _tally(counts)
    if not use_cuda(u):
        return poly_keyed_plain(u, v, key, planes, key_ok, pk)
    batch = key.shape
    if torch.broadcast_shapes(u.shape[:-1], v.shape[:-1], batch) != batch:
        raise ValueError("u %s and v %s do not broadcast to the keys' batch "
                         "%s" % (tuple(u.shape), tuple(v.shape), tuple(batch)))
    n, unflatten = flatten_batch(batch)
    dev = u.device
    with profiling.span("verify_kernel.poly_keyed_rows", n):
        u, v = _rows(u, batch, n, (32,)), _rows(v, batch, n, (64,))
        pk, key = pk.reshape(n, 32).contiguous(), key.reshape(n)
        planes, key_ok = _aligned(planes.contiguous()), key_ok.contiguous()
        out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
        ok = torch.empty((n,), dtype=torch.bool, device=dev)
        rows = max(1, keyed_scratch_rows(n, dev))
        scratch = torch.empty((rows,) + QT_SHAPE, dtype=torch.int8,
                              device=dev)
    build.launch("poly", "poly_keyed_launch", dev, out.data_ptr(),
                 ok.data_ptr(), scratch.data_ptr(), rows, u.data_ptr(),
                 v.data_ptr(), order.data_ptr(), key.data_ptr(),
                 counts.data_ptr(), planes.data_ptr(), key_ok.data_ptr(),
                 pk.data_ptr(), edwards_kernel.word_table(8, dev).data_ptr(),
                 n, n=n)
    launches["poly_keyed"] += 1
    return unflatten(out), unflatten(ok)


def keyed_scratch_rows(n, device):
    """Scratch rows of the keyed launch for n lanes on `device`, as the
    library decides them (a row a thread of one full wave, n at most)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return build.load_cuda("poly").poly_keyed_scratch_rows(n, sms)


def oneshot_scratch_rows(n, device):
    """Scratch rows of the one-shot launch for n lanes on `device`, as the
    library decides them (a row per thread of its grid)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return build.load_cuda("oneshot").oneshot_scratch_rows(n, sms)


def verify_oneshot(pk, u, v):
    """(enc(R') [..., 32] uint8, ok [...] bool) in one launch for CUDA
    tensors, verify_oneshot_plain for CPU ones. Batch axes broadcast."""
    _check(pk, "pk", torch.uint8, (32,))
    _check(u, "u", torch.int32, (32,))
    _check(v, "v", torch.int32, (64,))
    _same_device(pk, u, v)
    if not use_cuda(pk):
        return verify_oneshot_plain(pk, u, v)
    batch = torch.broadcast_shapes(pk.shape[:-1], u.shape[:-1], v.shape[:-1])
    n, unflatten = flatten_batch(batch)
    with profiling.span("verify_kernel.oneshot_rows", n):
        pk = _rows(pk, batch, n, (32,))
        u, v = _rows(u, batch, n, (32,)), _rows(v, batch, n, (64,))
        out = torch.empty((n, 32), dtype=torch.uint8, device=pk.device)
        ok = torch.empty((n,), dtype=torch.bool, device=pk.device)
        rows = oneshot_scratch_rows(n, pk.device)
        scratch = torch.empty((rows,) + QT_SHAPE, dtype=torch.int8,
                              device=pk.device)
    build.launch("oneshot", "oneshot_launch", pk.device, out.data_ptr(),
                 ok.data_ptr(), scratch.data_ptr(), rows, pk.data_ptr(),
                 u.data_ptr(), v.data_ptr(),
                 edwards_kernel.word_table(8, pk.device).data_ptr(), n, n=n)
    launches["oneshot"] += 1
    if rows:
        grid = rows // ONESHOT_BLOCK
        oneshot_warps["busiest"] += build.load_cuda(
            "oneshot").oneshot_busiest_warps(n, grid)
        oneshot_warps["mean"] += -(-n // 32) / grid
    return unflatten(out), unflatten(ok)


def digits(md, s):
    """(u [..., 32], v [..., 64]) int32 fold digits of S's bytes s [..., 32]
    and of h = md mod l from digests md [..., 64] uint8, by one launch of
    digits_kernel (see the module docstring): s broadcasts to md's batch,
    and its rows are read in place at their stride. Both on one card, each
    row's bytes contiguous; anything else raises."""
    _check(md, "md", torch.uint8, (64,))
    _check(s, "s", torch.uint8, (32,))
    _same_device(md, s)
    if not md.is_cuda:
        raise ValueError("digits runs on a card: md and s are on %s"
                         % md.device)
    batch = md.shape[:-1]
    n, unflatten = flatten_batch(batch)
    md, s = md.reshape(n, 64), s.expand(batch + (32,)).reshape(n, 32)
    if md.stride(1) != 1 or s.stride(1) != 1:
        raise ValueError("digits reads each row's bytes in order: md and s "
                         "have byte strides %d and %d"
                         % (md.stride(1), s.stride(1)))
    u = torch.empty((n, 32), dtype=torch.int32, device=md.device)
    v = torch.empty((n, 64), dtype=torch.int32, device=md.device)
    build.launch("digits", "digits_launch", md.device, u.data_ptr(),
                 v.data_ptr(), md.data_ptr(), md.stride(0), s.data_ptr(),
                 s.stride(0), n, n=n)
    launches["digits"] += 1
    return unflatten(u), unflatten(v)
