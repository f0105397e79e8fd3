"""ctypes bindings of the port's graph and plan builder (``csrc/
graphbuild.cpp``, C++/OpenMP), with the JAX package's names and return
shapes: linear-time CSR sorting, the v1 and v2 plans' chunk arrays, the
128×128 block counts and dense fill of the v3 and v5 plans, and R-MAT.

The library is compiled at first use (``build.py``).  A compiler or load
failure raises with the compiler's output: nothing falls back to numpy
quietly, so ``available()`` is True or raises.  The numpy builds beside each
call site stay the reference; tests reach them by patching ``available`` to
return False.  Each call runs ``torch.get_num_threads()`` OpenMP threads
(one in a process forked after the library loaded).

Every function checks what it passes to C: the ids in range, the input
row-sorted where the C code relies on it, and every count it narrows to
int32 below 2³¹.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from . import build

__all__ = ["available", "has_bsr", "has_plan_v2", "lib_path", "sort_csr",
           "plan_chunks", "plan_chunks_v2", "bsr_count", "bsr_fill",
           "compact_residual", "rmat"]

_I32_MAX = 2**31 - 1
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_i32, _i64 = ctypes.c_int32, ctypes.c_int64


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build()))
    lib.isplib_sort_csr.argtypes = [_i32p, _i32p, _i64, _i32, _i32, _i32p,
                                    _i64p, _i32p]
    lib.isplib_plan_count.restype = _i64
    lib.isplib_plan_count.argtypes = [_i32p, _i32p, _i64, _i32, _i32, _i32,
                                      _i32, _i32, _i64p, _i64p, _i64p]
    lib.isplib_plan_fill.argtypes = [_i32p, _i32p, _f32p, _i64, _i32, _i32,
                                     _i32, _i64p, _i64p, _i64, _i32p, _i32p]
    lib.isplib_plan_v2_count.restype = _i64
    lib.isplib_plan_v2_count.argtypes = [
        _i32p, _i32p, _i64, _i32, _i32, _i32, _i32, _i32, _i32, _i64p,
        _i64p, _i64p, _i64, _i32p]
    lib.isplib_plan_v2_fill.argtypes = [_i32p, _i32p, _f32p, _i64, _i32,
                                        _i32, _i32, _i64p, _i64p, _i32p]
    lib.isplib_rmat.argtypes = [_i64, _i32, ctypes.c_uint64, ctypes.c_double,
                                ctypes.c_double, ctypes.c_double, _i32p,
                                _i32p]
    lib.isplib_bsr_count.argtypes = [_i32p, _i32p, _i64, _i32, _i64, _i64,
                                     _i32p]
    lib.isplib_bsr_fill.argtypes = [_i32p, _i32p, _f32p, _i64, _i32, _i64,
                                    _i64, _i32, _i64p, _u16p, _u8p]
    lib.isplib_compact_residual.restype = _i64
    lib.isplib_compact_residual.argtypes = [_i32p, _i32p, _f32p, _u8p, _i64,
                                            _i32p, _i32p, _f32p]
    lib.isplib_set_num_threads.argtypes = [ctypes.c_int]
    lib.isplib_set_num_threads.restype = None
    lib.isplib_version.restype = ctypes.c_int
    return lib


# GNU libgomp's thread pool does not survive fork(): a child that starts a
# parallel region after its parent did waits forever for the parent's
# threads.  A forked child runs the builder on one thread; no array it
# builds depends on the thread count.
_forked = False


def _after_fork_in_child() -> None:
    global _forked
    _forked = True


os.register_at_fork(after_in_child=_after_fork_in_child)


def _lib() -> ctypes.CDLL:
    lib = _load()
    lib.isplib_set_num_threads(1 if _forked else torch.get_num_threads())
    return lib


def available() -> bool:
    """True once the library is built and loaded (a failure raises)."""
    _load()
    return True


def has_bsr() -> bool:
    """The v3/v5 block entry points: in the port's library whenever it
    loads."""
    return available()


def has_plan_v2() -> bool:
    """The v2 plan entry points: in the port's library whenever it loads."""
    return available()


def lib_path() -> str:
    return str(build.lib_path())


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _narrow(n: int, what: str) -> int:
    if not 0 <= n <= _I32_MAX:
        raise ValueError(f"{what} = {n} does not fit int32")
    return int(n)


def _ids(a, n: int, what: str) -> np.ndarray:
    """``a`` as contiguous int32, every id in [0, n)."""
    a = np.asarray(a)
    if a.ndim != 1:
        raise ValueError(f"{what} must be 1-D, got shape {a.shape}")
    _narrow(a.shape[0], f"len({what})")
    if a.size and (int(a.min()) < 0 or int(a.max()) >= n):
        raise ValueError(f"{what} holds ids outside [0, {n})")
    return np.ascontiguousarray(a, np.int32)


def _edges(row, col, num_rows: int, num_cols: int, sorted_rows: bool):
    row = _ids(row, _narrow(num_rows, "num_rows"), "row")
    col = _ids(col, _narrow(num_cols, "num_cols"), "col")
    if row.shape != col.shape:
        raise ValueError(f"row {row.shape} and col {col.shape} differ")
    if sorted_rows and bool(np.any(row[1:] < row[:-1])):
        raise ValueError("the native plan builds need row-sorted edges")
    return row, col


def _values(val, nnz: int) -> np.ndarray:
    val = np.ascontiguousarray(val, np.float32)
    if val.shape != (nnz,):
        raise ValueError(f"val {val.shape} does not match {nnz} edges")
    return val


def sort_csr(row: np.ndarray, col: np.ndarray, num_rows: int,
             num_cols: int) -> tuple[np.ndarray, np.ndarray]:
    """Stable (row, col) sort.  Returns (order int32, rowptr int64)."""
    row, col = _edges(row, col, num_rows, num_cols, False)
    nnz = int(row.shape[0])
    order = np.empty(nnz, np.int32)
    rowptr = np.empty(num_rows + 1, np.int64)
    scratch = np.empty(nnz, np.int32)
    _lib().isplib_sort_csr(
        _ptr(row, ctypes.c_int32), _ptr(col, ctypes.c_int32), nnz, num_rows,
        num_cols, _ptr(order, ctypes.c_int32), _ptr(rowptr, ctypes.c_int64),
        _ptr(scratch, ctypes.c_int32))
    return order, rowptr


def plan_chunks(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                num_rows: int, num_cols: int, rb: int, ct: int, eb: int):
    """The v1 plan's packed arrays of row-sorted COO.

    Returns (edges (nc, 3, eb) int32, rb_ids, ct_ids, chunk_starts), int32.
    """
    row, col = _edges(row, col, num_rows, num_cols, True)
    nnz = int(row.shape[0])
    val = _values(val, nnz)
    nrb = -(-num_rows // rb)
    chunk_of = np.empty(nnz, np.int64)
    rank = np.empty(nnz, np.int64)
    chunk_starts = np.empty(nrb + 1, np.int64)
    lib = _lib()
    nc = lib.isplib_plan_count(
        _ptr(row, ctypes.c_int32), _ptr(col, ctypes.c_int32), nnz, num_rows,
        num_cols, rb, ct, eb, _ptr(chunk_of, ctypes.c_int64),
        _ptr(rank, ctypes.c_int64), _ptr(chunk_starts, ctypes.c_int64))
    _narrow(nc, "the v1 chunk count")
    edges = np.zeros((nc, 3, eb), np.int32)
    ct_ids = np.zeros(nc, np.int32)
    lib.isplib_plan_fill(
        _ptr(row, ctypes.c_int32), _ptr(col, ctypes.c_int32),
        _ptr(val, ctypes.c_float), nnz, rb, ct, eb,
        _ptr(chunk_of, ctypes.c_int64), _ptr(rank, ctypes.c_int64), nc,
        _ptr(edges, ctypes.c_int32), _ptr(ct_ids, ctypes.c_int32))
    rb_ids = np.repeat(np.arange(nrb, dtype=np.int32), np.diff(chunk_starts))
    return edges, rb_ids, ct_ids, chunk_starts.astype(np.int32)


def plan_chunks_v2(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                   num_rows: int, num_cols: int, rb: int, ct: int, eb: int,
                   nrb_s: int):
    """The v2 plan's packed arrays of row-sorted COO.

    Returns (edges (nc, 3, eb) int32 [cols | vals | rows], rb_locals (nc,)
    int32, cell_starts (n_super·nct + 1,) int32).
    """
    row, col = _edges(row, col, num_rows, num_cols, True)
    nnz = int(row.shape[0])
    val = _values(val, nnz)
    nrb = -(-num_rows // rb)
    nct = -(-num_cols // ct)
    n_super = -(-nrb // nrb_s)
    chunk_of = np.empty(nnz, np.int64)
    rank = np.empty(nnz, np.int64)
    cell_starts = np.empty(n_super * nct + 1, np.int64)
    # at most one partial chunk per (superblock, column tile, row block)
    # bucket besides the full ones
    cap = _narrow(nnz // eb + nrb * nct + 1, "the v2 chunk bound")
    rb_locals = np.zeros(cap, np.int32)
    lib = _lib()
    nc = lib.isplib_plan_v2_count(
        _ptr(row, ctypes.c_int32), _ptr(col, ctypes.c_int32), nnz, num_rows,
        num_cols, rb, ct, eb, nrb_s, _ptr(chunk_of, ctypes.c_int64),
        _ptr(rank, ctypes.c_int64), _ptr(cell_starts, ctypes.c_int64), cap,
        _ptr(rb_locals, ctypes.c_int32))
    if nc > cap:
        raise RuntimeError(f"{nc} v2 chunks exceed their bound {cap}")
    edges = np.zeros((nc, 3, eb), np.int32)
    lib.isplib_plan_v2_fill(
        _ptr(row, ctypes.c_int32), _ptr(col, ctypes.c_int32),
        _ptr(val, ctypes.c_float), nnz, rb, ct, eb,
        _ptr(chunk_of, ctypes.c_int64), _ptr(rank, ctypes.c_int64),
        _ptr(edges, ctypes.c_int32))
    return edges, rb_locals[:nc], cell_starts.astype(np.int32)


def bsr_count(row: np.ndarray, col: np.ndarray, bs: int, n_br: int,
              n_bc: int) -> np.ndarray:
    """Per-(bs × bs)-block edge counts of row-sorted edges, (n_br·n_bc,)
    int32, block ``br·n_bc + bc``."""
    row, col = _edges(row, col, n_br * bs, n_bc * bs, True)
    counts = np.zeros(n_br * n_bc, np.int32)
    _lib().isplib_bsr_count(
        _ptr(row, ctypes.c_int32), _ptr(col, ctypes.c_int32),
        int(row.shape[0]), bs, n_br, n_bc, _ptr(counts, ctypes.c_int32))
    return counts


def bsr_fill(row: np.ndarray, col: np.ndarray, val: np.ndarray, bs: int,
             n_br: int, n_bc: int, g: int, rank: np.ndarray, nb_padded: int):
    """Densify the ranked blocks of row-sorted edges into the grouped bf16
    layout, duplicates summed in fp32 in edge order and rounded once.

    ``rank`` (n_br·n_bc,): each block's output slot, −1 where it stays
    sparse.  Returns (blocks (nb_padded/g, bs, g·bs) uint16 holding bf16,
    ``blocks[p // g, c, (p % g)·bs + r] = A[r, c]`` of slot p's block;
    is_dense (nnz,) uint8, 1 where the edge went to a block).
    """
    row, col = _edges(row, col, n_br * bs, n_bc * bs, True)
    nnz = int(row.shape[0])
    val = _values(val, nnz)
    rank = np.ascontiguousarray(rank, np.int64)
    if nb_padded % g or rank.shape != (n_br * n_bc,) or (
            rank.size and int(rank.max()) >= nb_padded):
        raise ValueError(f"rank {rank.shape} must hold slots below "
                         f"nb_padded = {nb_padded}, a multiple of g = {g}")
    blocks = np.zeros((nb_padded // g, bs, g * bs), np.uint16)
    is_dense = np.zeros(nnz, np.uint8)
    _lib().isplib_bsr_fill(
        _ptr(row, ctypes.c_int32), _ptr(col, ctypes.c_int32),
        _ptr(val, ctypes.c_float), nnz, bs, n_br, n_bc, g,
        _ptr(rank, ctypes.c_int64), _ptr(blocks, ctypes.c_uint16),
        _ptr(is_dense, ctypes.c_uint8))
    return blocks, is_dense


def compact_residual(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                     is_dense: np.ndarray):
    """The edges not flagged dense, in their order: (row, col) int32 and
    val float32."""
    row = np.ascontiguousarray(row, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    nnz = _narrow(row.shape[0], "nnz")
    val = _values(val, nnz)
    is_dense = np.ascontiguousarray(is_dense, np.uint8)
    if col.shape != (nnz,) or is_dense.shape != (nnz,):
        raise ValueError("row, col, val and is_dense must have one length")
    out_row = np.empty(nnz, np.int32)
    out_col = np.empty(nnz, np.int32)
    out_val = np.empty(nnz, np.float32)
    n = _lib().isplib_compact_residual(
        _ptr(row, ctypes.c_int32), _ptr(col, ctypes.c_int32),
        _ptr(val, ctypes.c_float), _ptr(is_dense, ctypes.c_uint8), nnz,
        _ptr(out_row, ctypes.c_int32), _ptr(out_col, ctypes.c_int32),
        _ptr(out_val, ctypes.c_float))
    return out_row[:n], out_col[:n], out_val[:n]


def rmat(num_edges: int, num_nodes: int, seed: int = 0, a: float = 0.57,
         b: float = 0.19, c: float = 0.19):
    """R-MAT edges, SplitMix64 per (seed, edge index), so the stream does
    not depend on the thread count.  Returns (src, dst) int32, self loops
    included (callers filter)."""
    _narrow(num_nodes - 1, "num_nodes - 1")
    if num_edges < 0:
        raise ValueError(f"num_edges = {num_edges} < 0")
    src = np.empty(num_edges, np.int32)
    dst = np.empty(num_edges, np.int32)
    _lib().isplib_rmat(num_edges, num_nodes, seed & (2**64 - 1), a, b, c,
                       _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32))
    return src, dst
