"""ctypes loader for the C++ host runtime (native/aligner_native.cpp).

The shared library is built lazily with ``g++ -O3`` on first use from
the repository's ``native/aligner_native.cpp`` (the same source the JAX
package loads) and cached next to this package.  Every entry point has a pure-Python
fallback (the oracle), so ``available()`` returning False only costs
speed, never correctness.

Native surface:
* ``fill_local/fill_global/fill_pwm`` — exact scalar DP (bit-identical
  to the oracle; ~1000x faster than the Python loops);
* ``traceback_batch`` — batched direction-plane walks, one C call per
  device batch;
* ``encode`` — byte→code compaction with frequencies and gap indices.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .errors import ValidationError

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "aligner_native.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_i64 = ctypes.c_int64
_p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_p_i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build(so_path: str) -> bool:
    try:
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        # -ffp-contract=off: GCC contracts a*b+c into FMA by default,
        # which rounds once instead of twice — the statistics fit (and
        # any future float kernel) must round exactly like NumPy's
        # elementwise ops to keep the bit-exactness contract.
        # Compile to a per-process temp name + atomic rename: N worker
        # processes on a fresh checkout all reach here concurrently, and
        # a half-written .so at the final path could be dlopen'd by a
        # sibling (rename makes publish all-or-nothing; last one wins).
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-ffp-contract=off",
             "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so_path)
        return True
    except Exception:
        return False
    finally:
        try:
            if os.path.exists(f"{so_path}.{os.getpid()}.tmp"):
                os.unlink(f"{so_path}.{os.getpid()}.tmp")
        except OSError:
            pass


def _candidates():
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    yield os.path.join(pkg_dir, "_aligner_native.so")


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("ALIGNER_NO_NATIVE"):
            return None
        have_src = os.path.exists(_SRC)
        for so in _candidates():
            # a prebuilt .so with no source next to it (wheel install,
            # moved tree) is used as-is — getmtime on the missing source
            # must not crash every alignment call out of available()
            stale = have_src and (
                not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(_SRC)
            )
            if not os.path.exists(so) or stale:
                if not have_src or not _build(so):
                    continue
            try:
                lib = ctypes.CDLL(so)
                if lib.an_abi_version() != 3:
                    continue
                _bind(lib)
                _LIB = lib
                return lib
            except (OSError, AttributeError):
                # OSError: dlopen failure; AttributeError: a foreign or
                # truncated .so without an_abi_version — try the next
                # candidate instead of propagating out of available()
                continue
        return None


def _bind(lib: ctypes.CDLL) -> None:
    lib.an_fill_local.argtypes = [
        _p_i8, _i64, _p_i8, _i64, _p_f64, _i64,
        ctypes.c_double, ctypes.c_double, _p_f64, _p_u8,
    ]
    lib.an_fill_global.argtypes = lib.an_fill_local.argtypes
    lib.an_fill_pwm.argtypes = [
        _p_i8, _i64, _p_f64, _i64,
        ctypes.c_double, ctypes.c_double, _p_f64, _p_u8,
    ]
    lib.an_argmax.argtypes = [_p_f64, _i64]
    lib.an_argmax.restype = _i64
    lib.an_traceback_batch.argtypes = [
        _p_u8, _i64, _i64, _i64, _p_i64, _p_i64,
        _p_i8, _i64, _p_i8, _i64, ctypes.c_int,
        _p_i16, _p_i16, _p_i64, _p_i64, _p_i64, _p_i64,
    ]
    lib.an_encode.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), _i64,
        _p_i16, _i64, _p_i8, _p_i64, _p_i64, _p_i64, _p_i64, _p_i64,
    ]
    lib.an_encode.restype = _i64
    lib.an_fill_local_stream.argtypes = [
        _p_i8, _i64, _p_i8, _i64, _p_f64, _i64,
        ctypes.c_double, ctypes.c_double, _i64,
        _p_f64, _p_f64, _p_f64, _p_i64, _p_i64,
    ]
    lib.an_replay_local_block.argtypes = [
        _p_i8, _p_i8, _i64, _p_f64, _i64,
        ctypes.c_double, ctypes.c_double, _i64, _i64,
        _p_f64, ctypes.c_double, _p_u8,
    ]
    lib.an_walk_local_cols.argtypes = [
        _p_u8, _i64, _i64, _i64, _p_i8, _p_i8,
        _p_i64, _p_i64, _p_i16, _p_i16, _p_i64,
    ]
    lib.an_walk_local_cols.restype = ctypes.c_int
    lib.an_estimate_h.argtypes = [
        _p_f64, _p_f64, _p_f64, _i64, ctypes.c_double, ctypes.c_double,
        _i64, ctypes.c_double, _p_f64,
    ]
    lib.an_estimate_h.restype = ctypes.c_double


def available() -> bool:
    return _load() is not None


def _check_codes(seq: np.ndarray, vol: int, what: str) -> None:
    """The C fills index the matrix with raw codes and (by design) do
    no bounds checks — a codec-legal BLANK=98/POS=99 that slipped into
    a sequence would read far out of bounds (UB) instead of raising
    like the oracle's fancy indexing does.  Validate at this single
    chokepoint into the native engine."""
    if len(seq) and (int(seq.max()) >= vol or int(seq.min()) < 0):
        bad = int(seq.max()) if int(seq.max()) >= vol else int(seq.min())
        raise ValidationError(
            f"{what} contains code {bad} outside the "
            f"{vol}-symbol scoring alphabet (gap/special codes are not "
            "alignable symbols; negative codes would index out of bounds)"
        )


def fill(q: np.ndarray, t: np.ndarray, matrix: np.ndarray,
         del_: float, ext: float, mode: str):
    """Exact scalar fill; returns (plane f64, dirs u8) like the oracle."""
    lib = _load()
    assert lib is not None
    q = np.ascontiguousarray(q, np.int8)
    matrix = np.ascontiguousarray(matrix, np.float64)
    if mode == "pwm":
        _check_codes(q, 4, "query")
        rows, cols = len(q), matrix.shape[1]
        plane = np.zeros((rows + 1, cols + 1), np.float64)
        dirs = np.full((rows + 1, cols + 1), 3, np.uint8)
        lib.an_fill_pwm(q, len(q), matrix, matrix.shape[1], del_, ext, plane, dirs)
        return plane, dirs
    t = np.ascontiguousarray(t, np.int8)
    _check_codes(q, matrix.shape[1], "query")
    _check_codes(t, matrix.shape[0], "target")
    rows, cols = len(t), len(q)
    plane = np.zeros((rows + 1, cols + 1), np.float64)
    dirs = np.full((rows + 1, cols + 1), 3, np.uint8)
    fn = lib.an_fill_local if mode == "local" else lib.an_fill_global
    fn(q, len(q), t, len(t), matrix, matrix.shape[1], del_, ext, plane, dirs)
    return plane, dirs


def argmax_first_rowmajor(plane: np.ndarray) -> tuple[int, int]:
    lib = _load()
    assert lib is not None
    flat = int(lib.an_argmax(np.ascontiguousarray(plane, np.float64), plane.size))
    return flat // plane.shape[1], flat % plane.shape[1]


def traceback_batch(
    dirs: np.ndarray,  # (B, rows1, cols1) uint8
    sy: np.ndarray,
    sx: np.ndarray,
    q: np.ndarray,  # (B, qmax) int8
    t: np.ndarray,  # (B, tmax) int8
    pwm_mode: bool,
):
    """Batched walks; returns (qa_list, ta_list, end_y, end_x) with each
    walk already reversed into alignment order."""
    lib = _load()
    assert lib is not None
    dirs = np.ascontiguousarray(dirs, np.uint8)
    B, rows1, cols1 = dirs.shape
    cap = rows1 + cols1 + 1
    qa_buf = np.empty(B * cap, np.int16)
    ta_buf = np.empty(B * cap, np.int16)
    offsets = np.empty(B, np.int64)
    lens = np.empty(B, np.int64)
    end_y = np.empty(B, np.int64)
    end_x = np.empty(B, np.int64)
    lib.an_traceback_batch(
        dirs, B, rows1, cols1,
        np.ascontiguousarray(sy, np.int64), np.ascontiguousarray(sx, np.int64),
        np.ascontiguousarray(q, np.int8), q.shape[1],
        np.ascontiguousarray(t, np.int8), t.shape[1],
        int(pwm_mode), qa_buf, ta_buf, offsets, lens, end_y, end_x,
    )
    qa = [qa_buf[offsets[b] : offsets[b] + lens[b]][::-1].copy() for b in range(B)]
    ta = [ta_buf[offsets[b] : offsets[b] + lens[b]][::-1].copy() for b in range(B)]
    return qa, ta, end_y, end_x


def default_stream_cb(qn: int) -> int:
    """Checkpoint cadence balancing the two memory terms of the
    streaming local fill — checkpoints cost (qn/cb)·tn·8 bytes, one
    replayed direction block costs cb·tn bytes; they equalize at
    cb = sqrt(8·qn).  Clamped to keep tiny problems single-block and
    huge ones from degenerate cadences."""
    return int(min(max(256, np.sqrt(8.0 * qn)), 65536))


def local_max_score_stream(q, t, matrix, del_: float, ext: float):
    """Forward-only streaming local fill: returns (f, my, mx) — the
    plane maximum and its first-in-row-major argmax — in O(tn) memory.
    Bit-identical to ``an_fill_local`` + ``an_argmax`` on the full
    plane (same op order; tests enforce it)."""
    lib = _load()
    assert lib is not None
    q = np.ascontiguousarray(q, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    matrix = np.ascontiguousarray(matrix, np.float64)
    _check_codes(q, matrix.shape[1], "query")
    _check_codes(t, matrix.shape[0], "target")
    qn, tn = len(q), len(t)
    cb = qn + 1  # no interior checkpoints: slot 0 only
    ck_cols = np.zeros((1, tn + 1), np.float64)
    ck_pen = np.zeros(1, np.float64)
    bv = np.zeros(1, np.float64)
    by = np.zeros(1, np.int64)
    bx = np.zeros(1, np.int64)
    lib.an_fill_local_stream(q, qn, t, tn, matrix, matrix.shape[1],
                             del_, ext, cb, ck_cols, ck_pen, bv, by, bx)
    return float(bv[0]), int(by[0]), int(bx[0])


def align_local_stream(q, t, matrix, del_: float, ext: float,
                       cb: int | None = None):
    """Memory-bounded exact local alignment of one huge pair.

    Streams the fill (O(tn) live state) with column checkpoints every
    ``cb`` columns, then replays one cb-wide direction block at a time
    for the traceback walk — peak memory O(tn·(qn/cb + cb)) instead of
    the O(qn·tn) plane the materializing engines need.  Returns
    ``(f, qa, ta, coords)`` with the exact reference semantics of
    ``host.align_local`` (simple/mod.rs:147-264), including the
    walk-seeding duplication quirk and first-row-major argmax; raises
    ResultIsEmpty when no cell scores positive."""
    from .errors import ResultIsEmpty

    lib = _load()
    assert lib is not None
    q = np.ascontiguousarray(q, np.int8)
    t = np.ascontiguousarray(t, np.int8)
    matrix = np.ascontiguousarray(matrix, np.float64)
    _check_codes(q, matrix.shape[1], "query")
    _check_codes(t, matrix.shape[0], "target")
    qn, tn = len(q), len(t)
    if qn == 0 or tn == 0:
        raise ResultIsEmpty("empty sequence")
    cb = int(cb) if cb else default_stream_cb(qn)
    n_ck = qn // cb
    ck_cols = np.empty((n_ck + 1, tn + 1), np.float64)
    ck_pen = np.empty(n_ck + 1, np.float64)
    bv = np.zeros(1, np.float64)
    by = np.zeros(1, np.int64)
    bx = np.zeros(1, np.int64)
    lib.an_fill_local_stream(q, qn, t, tn, matrix, matrix.shape[1],
                             del_, ext, cb, ck_cols, ck_pen, bv, by, bx)
    my, mx = int(by[0]), int(bx[0])
    if my == 0 or mx == 0:
        raise ResultIsEmpty("local alignment has no positive-scoring cell")

    cap = qn + tn + 2
    qa_buf = np.empty(cap, np.int16)
    ta_buf = np.empty(cap, np.int16)
    cy = np.array([my], np.int64)
    cx = np.array([mx], np.int64)
    n = np.zeros(1, np.int64)
    dirs = None
    while True:
        k = (int(cx[0]) - 1) // cb  # block covering columns (k·cb, …]
        x0 = k * cb
        nx = min(cb, qn - x0)
        if dirs is None or dirs.shape[0] < nx:
            dirs = np.empty((max(nx, 1), tn + 1), np.uint8)
        lib.an_replay_local_block(q, t, tn, matrix, matrix.shape[1],
                                  del_, ext, x0, nx, ck_cols[k],
                                  float(ck_pen[k]), dirs)
        done = lib.an_walk_local_cols(dirs, tn, x0, nx, q, t,
                                      cy, cx, qa_buf, ta_buf, n)
        if done or int(cx[0]) == 0:
            break
    nn = int(n[0])
    # the host walk seeds the argmax cell's characters BEFORE walking,
    # so after the reversal they land last (the reference quirk,
    # simple/mod.rs:212-218)
    qa = np.concatenate([qa_buf[:nn][::-1], [np.int16(q[mx - 1])]])
    ta = np.concatenate([ta_buf[:nn][::-1], [np.int16(t[my - 1])]])
    coords = ((int(cx[0]) + 1, mx + 1), (int(cy[0]) + 1, my + 1))
    return float(bv[0]), qa, ta, coords


def estimate_h(log_kqt: np.ndarray, kexp: np.ndarray, tl: np.ndarray,
               qlen: float, old_h: float, maxiter: int,
               threshold: float) -> float:
    """Compiled h-search (statistics/mod.rs:191-238) — bit-identical to
    statistics._estimate_h's Python loop (same expression structure,
    numpy-pairwise sums, -ffp-contract=off; self-checked at first use
    by statistics.py)."""
    lib = _load()
    assert lib is not None
    log_kqt = np.ascontiguousarray(log_kqt, np.float64)
    kexp = np.ascontiguousarray(kexp, np.float64)
    tl = np.ascontiguousarray(tl, np.float64)
    n = len(tl)
    scratch = np.empty(2 * max(n, 1), np.float64)
    return float(lib.an_estimate_h(
        log_kqt, kexp, tl, n, float(qlen), float(old_h),
        int(maxiter), float(threshold), scratch,
    ))


def encode(raw: bytes | np.ndarray, lut256: np.ndarray, vol: int):
    """Compacting encode; returns (codes int8, counts int64, indices
    ascending-coord list of (coord, offset, local))."""
    lib = _load()
    assert lib is not None
    raw = np.frombuffer(bytes(raw), np.uint8) if not isinstance(raw, np.ndarray) else raw
    raw = np.ascontiguousarray(raw, np.uint8)
    n = len(raw)
    out = np.empty(max(n, 1), np.int8)
    counts = np.zeros(vol, np.int64)
    idx_c = np.empty(max(n, 1), np.int64)
    idx_o = np.empty(max(n, 1), np.int64)
    idx_l = np.empty(max(n, 1), np.int64)
    n_idx = np.zeros(1, np.int64)
    kept = lib.an_encode(
        raw, n, np.ascontiguousarray(lut256, np.int16), vol,
        out, counts, idx_c, idx_o, idx_l, n_idx,
    )
    k = int(n_idx[0])
    return out[:kept].copy(), counts, list(zip(idx_c[:k], idx_o[:k], idx_l[:k]))
