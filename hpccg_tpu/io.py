"""Matrix / problem IO.

- read_hpc_row / write_hpc_row: the reference's "HPC row" text format
  (read_HPC_row.cpp:217-373; deprecated per README.md:114-118 but kept for
  parity). Token stream: ``total_nrow total_nnz``, then nnz-per-row counts,
  then (val, ind) pairs row-major, then (x, b, xexact) triples.
- dump_matlab: 1-indexed COO triplets for Matlab spconvert
  (dump_matlab_matrix.cpp:59-82).
- save_problem / load_problem: npz checkpoint of a Problem (+ optional CG
  state) — the persistence capability the reference lacks (SURVEY.md §5).

Host-side text parsing is vectorized NumPy (single fromstring pass), and an
optional C++ tokenizer (hpccg_tpu.native) accelerates the large-file path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hpccg_tpu.models.stencil import Problem
from hpccg_tpu.operators import DiaMatrix, EllMatrix, StencilOperator


def _tokenize(path: str) -> np.ndarray:
    """All whitespace-separated numeric tokens as float64."""
    try:
        from hpccg_tpu import native

        toks = native.tokenize_file(path)
        if toks is not None:
            return toks
    except ImportError:
        pass
    # NumPy-2-safe parse (np.fromstring's text mode is removed in NumPy 2.x
    # mainline): bytes.split handles arbitrary whitespace/ragged lines in C,
    # and np.array converts the byte tokens to float64 in one vectorized pass
    with open(path, "rb") as f:
        data = f.read()
    toks = data.split()
    if not toks:
        return np.zeros((0,), np.float64)
    return np.array(toks, dtype=np.float64)


def _matrix_to_device(A):
    """Move a host-leaf (numpy) EllMatrix onto the device. The readers run
    ALL structure analysis (to_dia, auto_structure, RCM) on host arrays and
    upload only the representation that will actually solve: a device round
    trip of the full ELL is wasted when the matrix converts to DIA anyway."""
    if isinstance(A, EllMatrix) and not isinstance(A.vals, jax.Array):
        return dataclasses.replace(
            A,
            vals=jnp.asarray(A.vals),
            cols=jnp.asarray(A.cols),
            valid=jnp.asarray(A.valid),
        )
    return A


def read_hpc_row(
    path: str, *, dtype=jnp.float64, to_dia: bool = True, device: bool = True
) -> Tuple[Problem, jax.Array]:
    """Load an HPC-row file into an explicit-matrix Problem.

    Returns (problem, x_file): the file carries an initial guess x alongside
    b/xexact (read_HPC_row.cpp:331-347); problem.x0 is that initial guess.

    With ``to_dia`` (default) a banded matrix (<= 128 distinct diagonals —
    every stencil-generated file qualifies) is converted to DIA storage,
    whose matvec is gather-free; unstructured matrices stay in padded ELL.
    """
    toks = _tokenize(path)
    if toks.size < 2:
        raise ValueError(f"{path}: not an HPC-row file (fewer than 2 tokens)")
    nrow = int(toks[0])
    nnz = int(toks[1])
    counts = toks[2 : 2 + nrow].astype(np.int64)
    if counts.size < nrow or counts.sum() != nnz:
        raise ValueError(
            f"{path}: header claims nrow={nrow} nnz={nnz}, "
            f"counts sum to {counts.sum() if counts.size == nrow else 'short file'}"
        )
    pos = 2 + nrow
    pairs = toks[pos : pos + 2 * nnz]
    if pairs.size < 2 * nnz:
        raise ValueError(f"{path}: truncated (val, ind) section")
    vals_flat = pairs[0::2]
    cols_flat = pairs[1::2].astype(np.int64)
    pos += 2 * nnz
    tail = toks[pos : pos + 3 * nrow]
    if tail.size < 3 * nrow:
        raise ValueError(f"{path}: truncated x/b/xexact section")
    x = tail[0::3]
    b = tail[1::3]
    xexact = tail[2::3]

    width = int(counts.max()) if nrow else 0
    vals = np.zeros((nrow, width))
    cols = np.zeros((nrow, width), dtype=np.int32)
    valid = np.zeros((nrow, width), dtype=bool)
    # scatter jagged rows into the padded layout
    row_ids = np.repeat(np.arange(nrow), counts)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_ids = np.arange(nnz) - np.repeat(offsets, counts)
    vals[row_ids, slot_ids] = vals_flat
    cols[row_ids, slot_ids] = cols_flat
    valid[row_ids, slot_ids] = True

    # host-leaf ELL: the structure decision (to_dia here, auto_structure in
    # the structured reader) reads these arrays with np.asarray — keeping
    # them numpy until the decision lands avoids a full device round trip
    # of the matrix (see _matrix_to_device)
    cdt = np.dtype(jnp.zeros((), dtype).dtype)  # canonicalized (x64-aware)
    A = EllMatrix(
        vals=vals.astype(cdt),
        cols=cols,
        valid=valid,
        start_row=0,
        total_nrow=nrow,
    )
    if to_dia:
        dia = A.to_dia()
        if dia is not None:
            A = dia
    if device:
        A = _matrix_to_device(A)
    prob = Problem(
        A=A,
        b=jnp.asarray(b, dtype),
        x0=jnp.asarray(x, dtype),
        xexact=jnp.asarray(xexact, dtype),
        total_nrow=nrow,
        total_nnz_model=nnz,
        total_nnz_exact=nnz,
    )
    return prob, prob.x0


def _iter_token_chunks(path: str, window: int = 1 << 20):
    """Yield float64 arrays of the file's numeric tokens, streaming through
    a fixed byte window with a carry for tokens split across window edges —
    the pure-Python counterpart of the native streaming tokenizer (bounded
    memory regardless of file size)."""
    carry = b""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(window)
            eof = len(chunk) < window
            data = carry + chunk
            carry = b""
            toks = data.split()
            if not eof and toks and data and not data[-1:].isspace():
                carry = toks.pop()  # may continue in the next window
            if toks:
                yield np.array(toks, dtype=np.float64)
            if eof:
                return


def _stream_tokens_py(path: str, skip: int, count: int) -> np.ndarray:
    """Tokens [skip, skip+count) via the bounded-memory chunk stream."""
    out = np.empty(max(count, 0), np.float64)
    got = 0
    to_skip = skip
    for arr in _iter_token_chunks(path):
        if to_skip >= len(arr):
            to_skip -= len(arr)
            continue
        take = arr[to_skip:]
        to_skip = 0
        k = min(len(take), count - got)
        out[got : got + k] = take[:k]
        got += k
        if got >= count:
            break
    return out[:got]


def _tokenize_range(path: str, skip: int, count: int) -> np.ndarray:
    """Native streaming range tokenizer with the Python fallback."""
    try:
        from hpccg_tpu import native

        toks = native.tokenize_range(path, skip, count)
        if toks is not None:
            return toks
    except ImportError:
        pass
    return _stream_tokens_py(path, skip, count)


def _scan_block_py(path: str, start_row: int, block_rows: int):
    """Python fallback of native.scan_block: one bounded-memory streaming
    pass over the header + ALL counts. Returns (total_nrow, total_nnz,
    prefix_nnz, block_nnz, block_max, global_max, block_counts)."""
    total_nrow = total_nnz = None
    counts = np.zeros(max(block_rows, 1), np.int64)
    prefix = 0
    gmax = 0
    pos = 0
    for arr in _iter_token_chunks(path):
        if pos == 0:
            if len(arr) < 2:
                raise ValueError(f"{path}: not an HPC-row file")
            total_nrow, total_nnz = int(arr[0]), int(arr[1])
        lo = max(2, pos)
        hi = min(2 + total_nrow, pos + len(arr))
        if hi > lo:
            cs = arr[lo - pos : hi - pos].astype(np.int64)
            rows = np.arange(lo - 2, hi - 2)
            if cs.size:
                gmax = max(gmax, int(cs.max()))
            prefix += int(cs[rows < start_row].sum())
            inblk = (rows >= start_row) & (rows < start_row + block_rows)
            counts[rows[inblk] - start_row] = cs[inblk]
        pos += len(arr)
        if pos >= 2 + total_nrow:
            break
    if total_nrow is None or pos < 2 + total_nrow:
        raise ValueError(f"{path}: truncated counts section")
    counts = counts[:block_rows]
    return (
        total_nrow, total_nnz, prefix, int(counts.sum()),
        int(counts.max()) if block_rows else 0, gmax, counts,
    )


def _scan_block(path: str, start_row: int, block_rows: int):
    try:
        from hpccg_tpu import native

        got = native.scan_block(path, start_row, block_rows)
        if got is not None:
            return got
    except ImportError:
        pass
    return _scan_block_py(path, start_row, block_rows)


def _assemble_ell_block(block_rows: int, width: int, counts, pairs):
    """Scatter a row block's (val, ind) token pairs into padded ELL arrays
    (shared by _read_block and the chained sharded reader)."""
    vals = np.zeros((block_rows, max(width, 1)))
    cols = np.zeros((block_rows, max(width, 1)), np.int32)
    valid = np.zeros((block_rows, max(width, 1)), bool)
    if block_rows:  # an empty block (all rows are pad) scatters nothing —
        # the offsets/counts broadcast below is ill-shaped at zero rows
        block_nnz = int(np.sum(counts))
        row_ids = np.repeat(np.arange(block_rows), counts)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot_ids = np.arange(block_nnz) - np.repeat(offsets, counts)
        vals[row_ids, slot_ids] = pairs[0::2]
        cols[row_ids, slot_ids] = pairs[1::2].astype(np.int64)
        valid[row_ids, slot_ids] = True
    return vals, cols, valid


def _read_block(path: str, start_row: int, block_rows: int, *, dtype, width=None):
    """Bounded-memory read of rows [start_row, start_row+block_rows) of an
    HPC-row file — the reference's per-rank read (read_HPC_row.cpp:255-293
    reads ONLY the local row block); peak host memory O(block + 1 MiB
    stream window), never the global matrix.

    Returns (EllMatrix block [host leaves, start_row/total_nrow set,
    global columns], x, b, xexact block slices, total_nnz). ``width``
    overrides the padded width (defaults to the GLOBAL max row count so
    every process derives the same uniform layout)."""
    (total_nrow, total_nnz, prefix, block_nnz, _bmax, gmax, counts) = _scan_block(
        path, start_row, block_rows
    )
    if start_row + block_rows > total_nrow:
        raise ValueError(
            f"block [{start_row}, {start_row + block_rows}) exceeds "
            f"{total_nrow} rows"
        )
    width = int(gmax if width is None else width)
    pairs = _tokenize_range(path, 2 + total_nrow + 2 * prefix, 2 * block_nnz)
    if pairs.size < 2 * block_nnz:
        raise ValueError(f"{path}: truncated (val, ind) section")
    triples = _tokenize_range(
        path, 2 + total_nrow + 2 * total_nnz + 3 * start_row, 3 * block_rows
    )
    if triples.size < 3 * block_rows:
        raise ValueError(f"{path}: truncated x/b/xexact section")

    vals, cols, valid = _assemble_ell_block(block_rows, width, counts, pairs)
    cdt = np.dtype(jnp.zeros((), dtype).dtype)
    A = EllMatrix(
        vals=vals.astype(cdt),
        cols=cols,
        valid=valid,
        start_row=start_row,
        total_nrow=total_nrow,
    )
    x = triples[0::3].astype(cdt)
    b = triples[1::3].astype(cdt)
    xexact = triples[2::3].astype(cdt)
    return A, x, b, xexact, total_nnz


def read_hpc_row_block(path: str, rank: int, size: int, *, dtype=jnp.float64):
    """One rank's row block by the reference's partition rule
    (read_HPC_row.cpp:255-266: floor division, remainder rows to the low
    ranks). See _read_block for the memory contract."""
    hdr = _tokenize_range(path, 0, 2)
    if hdr.size < 2:
        raise ValueError(f"{path}: not an HPC-row file (fewer than 2 tokens)")
    total_nrow = int(hdr[0])
    base, rem = divmod(total_nrow, size)
    start = rank * base + min(rank, rem)
    rows = base + (1 if rank < rem else 0)
    return _read_block(path, start, rows, dtype=dtype)


def _stream_local_blocks(path, plan, total_nrow, total_nnz, dtype):
    """Per-device (vals, cols, valid, x, b, xexact) host blocks for the
    sharded reader.

    With the native chained-cursor tokenizer each file section streams in
    ONE forward pass for the whole process (the per-device blocks are
    adjacent): header -> counts -> local (val, ind) pairs -> local triples,
    so a multi-device file costs ~1.5 full parses per process instead of the
    3-per-device token-skip re-parses from byte 0 the naive plan pays.
    Falls back to per-device _read_block without the native library."""
    cdt = np.dtype(jnp.zeros((), dtype).dtype)
    try:
        from hpccg_tpu import native

        chain_ok = native.available()
    except ImportError:
        chain_ok = False
    if not chain_ok:
        out = []
        width = None
        for _dev, start, _stop, real, _pad in plan:
            # a block that is ALL pad (tiny file on a big mesh) still scans
            # the header for the global width; clamp its start into the file
            A, x, b, xexact, _ = _read_block(
                path, min(start, total_nrow), real, dtype=dtype, width=width
            )
            width = A.vals.shape[1]
            out.append(
                (np.asarray(A.vals), np.asarray(A.cols), np.asarray(A.valid),
                 x, b, xexact)
            )
        return out

    # ONE scan covers every local row: prefix nnz, per-row counts, and the
    # global max count (the uniform ELL width every process derives)
    fs = min(min(min(s, total_nrow) for _d, s, *_ in plan), total_nrow)
    local_rows = sum(r for _d, _s, _st, r, _p in plan)
    (_tn, _tz, prefix, _bn, _bm, gmax, counts_local) = _scan_block(
        path, fs, local_rows
    )
    width = max(int(gmax), 1)
    _hdr, hdr_end = native.tokenize_range_at(path, 0, 0, 2)
    _z, counts_end = native.tokenize_range_at(path, hdr_end, total_nrow, 0)

    out = []
    cursor, skip, row0, consumed = counts_end, 2 * int(prefix), 0, int(prefix)
    for _dev, _start, _stop, real, _pad in plan:
        cnts = counts_local[row0 : row0 + real]
        row0 += real
        bn = int(cnts.sum())
        pairs, cursor = native.tokenize_range_at(path, cursor, skip, 2 * bn)
        skip = 0
        if pairs.size < 2 * bn:
            raise ValueError(f"{path}: truncated (val, ind) section")
        consumed += bn
        out.append(list(_assemble_ell_block(real, width, cnts, pairs)))

    # x/b/xexact triples: skip the tail of the pairs section once, then chain
    _z, cur3 = native.tokenize_range_at(
        path, cursor, 2 * (total_nnz - consumed), 0
    )
    skip = 3 * fs
    for i, (_dev, _start, _stop, real, _pad) in enumerate(plan):
        triples, cur3 = native.tokenize_range_at(path, cur3, skip, 3 * real)
        skip = 0
        if triples.size < 3 * real:
            raise ValueError(f"{path}: truncated x/b/xexact section")
        vals, cols, valid = out[i]
        out[i] = (
            vals.astype(cdt), cols, valid,
            triples[0::3].astype(cdt),
            triples[1::3].astype(cdt),
            triples[2::3].astype(cdt),
        )
    return out


def read_hpc_row_sharded(path: str, mesh, *, axis="z", dtype=jnp.float64):
    """Distributed bounded-memory loading: each ADDRESSABLE device's row
    block is streamed with _read_block and placed directly on that device;
    the global arrays are assembled with
    jax.make_array_from_single_device_arrays. No process ever materializes
    the global matrix on host — per-process peak RSS is
    O(rows_per_device x width x addressable_devices + 1 MiB), the
    reference's read_HPC_row memory contract at any device count
    (read_HPC_row.cpp:255-293).

    Rows that do not divide the mesh are identity-padded inside the LAST
    device's block (same decoupled pad rows as pad_problem_rows — the CG
    trajectory is unchanged). Returns a Problem whose EllMatrix leaves are
    row-sharded jax Arrays with GLOBAL columns, ready for
    parallel.make_distributed_ell_cg, plus x_file (the file's initial
    guess, sharded).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hpccg_tpu.parallel.mesh import axis_size

    hdr = _tokenize_range(path, 0, 2)
    if hdr.size < 2:
        raise ValueError(f"{path}: not an HPC-row file (fewer than 2 tokens)")
    total_nrow, total_nnz = int(hdr[0]), int(hdr[1])
    ndev = axis_size(mesh, axis)
    n_pad = -(-total_nrow // ndev) * ndev
    L = n_pad // ndev

    vec_sh = NamedSharding(mesh, P(axis))
    mat_sh = NamedSharding(mesh, P(axis, None))
    # device -> row slice, from the sharding itself (correct for 1-D and
    # multi-axis row meshes alike)
    idx_map = vec_sh.addressable_devices_indices_map((n_pad,))

    # device -> (start, stop, real, pad), host-major ascending (contiguous
    # local rows per process)
    plan = []
    for dev, idx in sorted(
        idx_map.items(), key=lambda kv: kv[1][0].start or 0
    ):
        sl = idx[0]
        start, stop = sl.start or 0, sl.stop if sl.stop is not None else n_pad
        real = max(0, min(stop, total_nrow) - start)
        plan.append((dev, start, stop, real, (stop - start) - real))

    blocks = _stream_local_blocks(path, plan, total_nrow, total_nnz, dtype)

    width = None
    mats = {"vals": [], "cols": [], "valid": []}
    vecs = {"x": [], "b": [], "xexact": []}
    devs = []
    for (dev, start, stop, real, pad), (av, ac, am, x, b, xexact) in zip(
        plan, blocks
    ):
        width = av.shape[1]
        if pad:
            # identity pad rows, decoupled: solve to exactly 0
            av = np.concatenate([av, np.zeros((pad, width), av.dtype)])
            ac = np.concatenate([ac, np.zeros((pad, width), ac.dtype)])
            am = np.concatenate([am, np.zeros((pad, width), am.dtype)])
            av[real:, 0] = 1.0
            ac[real:, 0] = np.arange(start + real, stop)
            am[real:, 0] = True
            zpad = np.zeros((pad,), x.dtype)
            x, b, xexact = (
                np.concatenate([v, zpad]) for v in (x, b, xexact)
            )
        for key, arr in (("vals", av), ("cols", ac), ("valid", am)):
            mats[key].append(jax.device_put(jnp.asarray(arr), dev))
        for key, arr in (("x", x), ("b", b), ("xexact", xexact)):
            vecs[key].append(jax.device_put(jnp.asarray(arr), dev))
        devs.append(dev)

    def assemble(parts, shape, sharding):
        return jax.make_array_from_single_device_arrays(shape, sharding, parts)

    cdt = jnp.zeros((), dtype).dtype
    A = EllMatrix(
        vals=assemble(mats["vals"], (n_pad, width), mat_sh),
        cols=assemble(mats["cols"], (n_pad, width), mat_sh),
        valid=assemble(mats["valid"], (n_pad, width), mat_sh),
        start_row=0,
        total_nrow=n_pad,
    )
    x_file = assemble(vecs["x"], (n_pad,), vec_sh)
    prob = Problem(
        A=A,
        b=assemble(vecs["b"], (n_pad,), vec_sh),
        x0=x_file,
        xexact=assemble(vecs["xexact"], (n_pad,), vec_sh),
        total_nrow=n_pad,
        total_nnz_model=total_nnz,
        total_nnz_exact=total_nnz,
    )
    return prob, x_file


def read_hpc_row_structured(path: str, *, dtype=jnp.float64, reorder: bool = True):
    """Load an HPC-row file and pick the representation it solves in.

    Beyond :func:`read_hpc_row`'s direct banded->DIA conversion, this runs
    :func:`hpccg_tpu.reorder.auto_structure`: a matrix that is a hidden
    banded matrix under a row/column permutation is RCM-reordered and solved
    in the reordered basis (CG is basis-invariant — b is permuted once here,
    x must be unpermuted once by the caller via the returned ``perm``).
    ``reorder=False`` disables RCM but keeps the banded->DIA conversion.

    Returns (problem, perm, report): ``problem`` is in the *solve* basis
    (b/x0/xexact permuted consistently with A); ``perm`` is None when no
    reordering was applied, else ``x_original[perm[i]] = x_solved[i]``.
    """
    from hpccg_tpu.reorder import auto_structure

    prob, _ = read_hpc_row(path, dtype=dtype, to_dia=False, device=False)
    A, perm, report = auto_structure(prob.A, reorder=reorder)
    A = _matrix_to_device(A)  # the ELL choice keeps host leaves until here
    if perm is not None:
        p = np.asarray(perm)
        prob = Problem(
            A=A,
            b=jnp.asarray(np.asarray(prob.b)[p]),
            x0=jnp.asarray(np.asarray(prob.x0)[p]),
            xexact=jnp.asarray(np.asarray(prob.xexact)[p]),
            total_nrow=prob.total_nrow,
            total_nnz_model=prob.total_nnz_model,
            total_nnz_exact=prob.total_nnz_exact,
        )
    else:
        prob = dataclasses.replace(prob, A=A)
    return prob, perm, report


def pad_problem_rows(prob: Problem, multiple: int) -> Problem:
    """Pad an explicit-matrix problem so its row count divides ``multiple``
    (shard_map needs equal shards — the analog of read_HPC_row.cpp:255-266's
    remainder handling, solved by padding instead of ragged blocks).

    Pad rows are decoupled identity rows with b = x0 = xexact = 0: they
    solve to exactly 0, contribute 0 to every dot product once converged,
    and nothing references them — the CG trajectory on the real rows is
    IDENTICAL to the unpadded problem's (pad residuals are 0 from the first
    iteration). total_nrow reflects the padded size; the FLOP/nnz models
    keep the true counts.
    """
    n = prob.total_nrow
    npad = ((n + multiple - 1) // multiple) * multiple
    if npad == n:
        return prob
    extra = npad - n
    A = prob.A
    if isinstance(A, EllMatrix):
        width = max(A.width, 1)
        vals = np.zeros((npad, width), np.asarray(A.vals).dtype)
        cols = np.zeros((npad, width), np.int32)
        valid = np.zeros((npad, width), bool)
        vals[:n, : A.width] = np.asarray(A.vals)
        cols[:n, : A.width] = np.asarray(A.cols)
        valid[:n, : A.width] = np.asarray(A.valid)
        vals[n:, 0] = 1.0
        cols[n:, 0] = np.arange(n, npad)
        valid[n:, 0] = True
        A2 = EllMatrix(
            vals=jnp.asarray(vals), cols=jnp.asarray(cols),
            valid=jnp.asarray(valid), start_row=0, total_nrow=npad,
        )
    elif isinstance(A, DiaMatrix):
        offs = list(A.offsets)
        data = np.asarray(A.data)
        if 0 not in offs:
            at = int(np.searchsorted(np.asarray(offs), 0))
            offs.insert(at, 0)
            data = np.insert(data, at, 0.0, axis=0)
        data2 = np.zeros((len(offs), npad), data.dtype)
        data2[:, :n] = data
        d0 = offs.index(0)
        data2[d0, n:] = 1.0
        A2 = DiaMatrix(
            data=jnp.asarray(data2), offsets=tuple(offs), total_nrow=npad
        )
    else:
        raise TypeError(
            "pad_problem_rows pads explicit matrices; the stencil operator "
            "shards by construction"
        )

    def padv(v):
        return jnp.concatenate(
            [jnp.asarray(v), jnp.zeros((extra,), jnp.asarray(v).dtype)]
        )

    return Problem(
        A=A2,
        b=padv(prob.b),
        x0=padv(prob.x0),
        xexact=padv(prob.xexact),
        total_nrow=npad,
        total_nnz_model=prob.total_nnz_model,
        total_nnz_exact=prob.total_nnz_exact,
    )


def unpermute(x, perm) -> np.ndarray:
    """Map a solve-basis vector back to the file's original row order."""
    x = np.asarray(x)
    if perm is None:
        return x
    out = np.empty_like(x)
    out[np.asarray(perm)] = x
    return out


def write_hpc_row(path: str, prob: Problem, x: Optional[np.ndarray] = None) -> None:
    """Serialize a Problem to the HPC-row text format (inverse of the reader)."""
    A = prob.A
    if isinstance(A, StencilOperator):
        raise TypeError("write_hpc_row needs an explicit matrix; use generate_ell")
    nrow = A.local_nrow
    x = np.zeros(nrow) if x is None else np.asarray(x)
    b = np.asarray(prob.b)
    xexact = np.asarray(prob.xexact)
    if isinstance(A, EllMatrix):
        try:
            from hpccg_tpu import native

            if native.write_hpc_row_native(
                path, np.asarray(A.vals), np.asarray(A.cols),
                np.asarray(A.valid), x, b, xexact,
            ):
                return
        except ImportError:
            pass
    rows, cols, vals = A.to_coo()
    counts = np.asarray(A.nnz_per_row())
    with open(path, "w") as f:
        f.write(f"{nrow} {counts.sum()}\n")
        f.write(" ".join(str(c) for c in counts) + "\n")
        k = 0
        for r in range(nrow):
            parts = []
            for _ in range(counts[r]):
                parts.append(f"{vals[k]:.17g} {cols[k]}")
                k += 1
            f.write(" ".join(parts) + "\n")
        for i in range(nrow):
            f.write(f"{x[i]:.17g} {b[i]:.17g} {xexact[i]:.17g}\n")


def dump_matlab(
    prefix: str,
    A,
    rank: int = 0,
    start_row: int = 0,
    perm=None,
    true_nrow: Optional[int] = None,
) -> Optional[str]:
    """Write 1-indexed (row, col, val) triplets to <prefix><rank>.dat for
    Matlab spconvert (ref dump_matlab_matrix.cpp:59-82; ranks > 3 are no-ops).

    ``start_row`` offsets the row (and, for a z-stacked stencil shard, the
    column) numbering — pass ``rank * local_nrow`` to dump one shard of a
    distributed problem exactly as the reference's per-rank dumps do.

    ``perm``/``true_nrow`` map a solve-basis matrix back to the loaded
    file's basis (the reference dump reflects the actual input ordering):
    pad rows >= true_nrow are stripped, then rows/cols are relabeled via
    ``perm`` (solve row i = original row perm[i]) and re-sorted row-major.
    """
    if rank > 3:
        return None
    if isinstance(A, StencilOperator):
        import dataclasses as _dc

        from hpccg_tpu.config import ProblemConfig
        from hpccg_tpu.models.stencil import generate_ell

        ell = generate_ell(
            ProblemConfig(A.nx, A.ny, A.nz, stencil=A.stencil, dtype=A.dtype)
        ).A
        if start_row:
            # z-stacked shard: global row AND column ids shift together
            A = _dc.replace(
                ell, cols=ell.cols + start_row, start_row=start_row
            )
        else:
            A = ell
    elif start_row:
        raise ValueError(
            "start_row applies to stencil shards; explicit matrices carry "
            "their own partition metadata (EllMatrix.start_row)"
        )
    rows, cols, vals = A.to_coo()
    if true_nrow is not None:
        keep = (np.asarray(rows) < true_nrow) & (np.asarray(cols) < true_nrow)
        rows, cols, vals = (
            np.asarray(rows)[keep], np.asarray(cols)[keep], np.asarray(vals)[keep]
        )
    if perm is not None:
        p = np.asarray(perm)
        rows = p[np.asarray(rows, np.int64)]
        cols = p[np.asarray(cols, np.int64)]
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], np.asarray(vals)[order]
    path = f"{prefix}{rank}.dat"
    with open(path, "w") as f:
        for r, c, v in zip(rows, cols, vals):
            f.write(f" {r + 1} {c + 1} {v:22.16e}\n")
    return path


def save_problem(path: str, prob: Problem, state: Optional[dict] = None) -> None:
    """Checkpoint a Problem (and optional solver state) as npz."""
    arrs = {
        "b": np.asarray(prob.b),
        "x0": np.asarray(prob.x0),
        "xexact": np.asarray(prob.xexact),
        "meta": np.asarray(
            [prob.total_nrow, prob.total_nnz_model, prob.total_nnz_exact]
        ),
    }
    A = prob.A
    if isinstance(A, StencilOperator):
        arrs["stencil_meta"] = np.asarray([A.nx, A.ny, A.nz, A.stencil.value])
        arrs["stencil_dtype"] = np.asarray(A.dtype_name)
    elif isinstance(A, DiaMatrix):
        arrs["dia_data"] = np.asarray(A.data)
        arrs["dia_offsets"] = np.asarray(A.offsets, np.int64)
        arrs["dia_meta"] = np.asarray([A.total_nrow or -1])
    else:
        arrs["vals"] = np.asarray(A.vals)
        arrs["cols"] = np.asarray(A.cols)
        arrs["valid"] = np.asarray(A.valid)
        arrs["ell_meta"] = np.asarray([A.start_row, A.total_nrow or -1])
    if state:
        for k, v in state.items():
            arrs[f"state_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrs)


def load_problem(path: str) -> Tuple[Problem, dict]:
    """Inverse of save_problem. Returns (problem, state_dict)."""
    from hpccg_tpu.config import Stencil

    z = np.load(path, allow_pickle=False)
    meta = z["meta"]
    if "stencil_meta" in z:
        nx, ny, nz, sv = (int(v) for v in z["stencil_meta"])
        A = StencilOperator(
            nx=nx, ny=ny, nz=nz, stencil=Stencil(sv), dtype_name=str(z["stencil_dtype"])
        )
    elif "dia_data" in z:
        total = int(z["dia_meta"][0])
        A = DiaMatrix(
            data=jnp.asarray(z["dia_data"]),
            offsets=tuple(int(o) for o in z["dia_offsets"]),
            total_nrow=None if total < 0 else total,
        )
    else:
        start_row, total = (int(v) for v in z["ell_meta"])
        A = EllMatrix(
            vals=jnp.asarray(z["vals"]),
            cols=jnp.asarray(z["cols"]),
            valid=jnp.asarray(z["valid"]),
            start_row=start_row,
            total_nrow=None if total < 0 else total,
        )
    prob = Problem(
        A=A,
        b=jnp.asarray(z["b"]),
        x0=jnp.asarray(z["x0"]),
        xexact=jnp.asarray(z["xexact"]),
        total_nrow=int(meta[0]),
        total_nnz_model=int(meta[1]),
        total_nnz_exact=int(meta[2]),
    )
    state = {
        k[len("state_") :]: z[k] for k in z.files if k.startswith("state_")
    }
    return prob, state
