"""SpGEMM (sparse × sparse): C = A·B.

Counterpart of lilac_tpu/ops/spgemm.py. It holds no hand kernel: the JAX
package runs these products through XLA ops (its only Pallas-free op
module), so here they are plain torch ops on the card. Four paths:

* gustavson(...)    host reference, row-wise Gustavson (a loop a row), the
                    oracle of the tests; numpy, the JAX package's bit for bit;
* expand_csr(...)   host vectorised Gustavson: every partial product in one
                    repeat / gather pass, then canonical CSR through
                    coo_to_csr_arrays; numpy, the JAX package's bit for bit;
* esc_spgemm(...)   ESC (expand / sort / compress) on the card, a group of
                    A's rows at a time, the group sized by the card's free
                    memory;
* masked_dense(...) the densified operands through torch.matmul in f32
                    (the JAX package's jnp.dot), for n·m that fits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from lilac_tpu_torch.formats.convert import coo_to_csr_arrays, csr_to_ell_arrays

# device bytes one ELL-padded slot of the expansion can hold at its peak:
# the gathered B column (int32) and value, the product, the validity mask,
# the int64 key, and for the slots that hold a product their compacted key
# and value, the sort's output and permutation
ESC_BYTES_PER_SLOT = 48
# share of the card's free memory one group of rows may take
ESC_FREE_SHARE = 0.25
# budget of one group on the CPU, where there is no free-memory query
ESC_HOST_BUDGET = 1 << 30


def gustavson(
    a: Tuple[np.ndarray, np.ndarray, np.ndarray],
    b: Tuple[np.ndarray, np.ndarray, np.ndarray],
    shape_a: Tuple[int, int],
    shape_b: Tuple[int, int],
):
    """Row-wise Gustavson SpGEMM on the host. Inputs / outputs canonical CSR."""
    assert shape_a[1] == shape_b[0]
    a_ptr, a_idx, a_val = a
    b_ptr, b_idx, b_val = b
    n, m = shape_a[0], shape_b[1]

    out_ptr = np.zeros(n + 1, dtype=np.int64)
    rows_idx = []
    rows_val = []
    acc = np.zeros(m, dtype=np.float64)
    # occupancy is tracked with a marker array, not by testing acc for 0.0:
    # an exact-zero product or a cancelling partial sum must not re-enter
    # `touched` (it would emit duplicate CSR entries)
    mark = np.zeros(m, dtype=bool)
    touched = np.empty(m, dtype=np.int64)
    for i in range(n):
        ntouch = 0
        for k_pos in range(a_ptr[i], a_ptr[i + 1]):
            k = a_idx[k_pos]
            av = a_val[k_pos]
            lo, hi = b_ptr[k], b_ptr[k + 1]
            cols = b_idx[lo:hi]
            newcols = cols[~mark[cols]]
            mark[newcols] = True
            touched[ntouch : ntouch + len(newcols)] = newcols
            ntouch += len(newcols)
            acc[cols] += av * b_val[lo:hi]
        cols_i = np.sort(touched[:ntouch])
        rows_idx.append(cols_i.copy())
        rows_val.append(acc[cols_i].copy())
        acc[cols_i] = 0.0
        mark[cols_i] = False
        out_ptr[i + 1] = out_ptr[i] + len(cols_i)
    return (
        out_ptr,
        np.concatenate(rows_idx) if rows_idx else np.empty(0, np.int64),
        np.concatenate(rows_val) if rows_val else np.empty(0),
        (n, m),
    )


def expand_csr(
    a: Tuple[np.ndarray, np.ndarray, np.ndarray],
    b: Tuple[np.ndarray, np.ndarray, np.ndarray],
    shape_a: Tuple[int, int],
    shape_b: Tuple[int, int],
):
    """Host vectorised Gustavson by expansion: every partial product
    (i, j, a_ik·b_kj) in one repeat / gather pass (no loop a row), then
    canonical CSR (sort + duplicate sum) through coo_to_csr_arrays."""
    assert shape_a[1] == shape_b[0]
    a_ptr, a_idx, a_val = a
    b_ptr, b_idx, b_val = b
    n, m = shape_a[0], shape_b[1]
    rows_a = np.repeat(np.arange(n, dtype=np.int64), np.diff(a_ptr))
    lens = np.diff(b_ptr)[a_idx]  # B-row length per A entry
    total = int(lens.sum())
    if total == 0:
        return (np.zeros(n + 1, np.int64), np.empty(0, np.int64),
                np.empty(0), (n, m))
    starts = b_ptr[a_idx]
    ends = np.cumsum(lens)
    offs = np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
    pos = np.repeat(starts, lens) + offs
    out_rows = np.repeat(rows_a, lens)
    out_cols = b_idx[pos]
    out_vals = np.repeat(a_val, lens) * b_val[pos]
    ptr, idx, val = coo_to_csr_arrays(out_rows, out_cols, out_vals, (n, m))
    return ptr, idx, val, (n, m)


def esc_budget_bytes(device) -> int:
    """Device bytes one group of ESC may take: ESC_FREE_SHARE of the card's
    free memory (torch.cuda.mem_get_info), ESC_HOST_BUDGET on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return ESC_HOST_BUDGET
    free, _ = torch.cuda.mem_get_info(device)
    return int(free * ESC_FREE_SHARE)


def esc_group_rows(n: int, ka: int, kb: int, budget: int,
                   row_chunk: Optional[int] = None) -> int:
    """Rows of A one group expands: as many as keep its ka·kb ELL-padded
    slots a row within `budget` bytes (ESC_BYTES_PER_SLOT each), at least
    one; a multiple of `row_chunk` rows when one is given."""
    per_row = max(ka, 1) * max(kb, 1) * ESC_BYTES_PER_SLOT
    rows = max(1, budget // per_row)
    if row_chunk is not None:
        rows = row_chunk * max(1, rows // row_chunk)
    return int(min(rows, max(n, 1)))


def _esc_group(va, ca, cnt_a, vb, cb, cnt_b, m: int):
    """One group of rows on the device. va / ca: [R, Ka] ELL rows of A (B's
    row ids), cnt_a their true lengths; vb / cb / cnt_b: B in ELL. Returns
    the group's (row · m + col) keys, sorted and unique, and their sums."""
    R, Ka = ca.shape
    Kb = cb.shape[1]
    dev = ca.device
    bcols = cb[ca]  # [R, Ka, Kb]
    prods = va[:, :, None] * vb[ca]
    valid = ((torch.arange(Ka, device=dev)[None, :] < cnt_a[:, None])[:, :, None]
             & (torch.arange(Kb, device=dev)[None, None, :] < cnt_b[ca][:, :, None]))
    rows = torch.arange(R, device=dev, dtype=torch.int64)[:, None, None]
    # one int64 key: row * m + col passes 2^31 at R = 16384, m = 262144
    keys = (rows * m + bcols).masked_select(valid)
    pv = prods.masked_select(valid)
    del bcols, prods, valid
    if keys.numel() == 0:
        return keys, pv
    # a stable sort keeps each (row, col) group's products in A's column
    # order; the segment sum then adds them in that order on every run
    keys, order = torch.sort(keys, stable=True)
    pv = pv[order]
    ukeys, counts = torch.unique_consecutive(keys, return_counts=True)
    sums = torch.segment_reduce(pv, "sum", lengths=counts)
    return ukeys, sums


def esc_spgemm(a_csr, b_csr, shape_a, shape_b, *, row_chunk: Optional[int] = None,
               dtype=np.float32, device_budget_bytes: Optional[int] = None,
               device="cuda"):
    """ESC SpGEMM on `device`: returns canonical host CSR of C = A·B with
    values in `dtype` (summed on the device), widened to f64.

    Rows of C depend only on the same rows of A, so cutting A's rows into
    groups is exact. Each group expands to an ELL-padded [rows, Ka, Kb]
    product tensor; its valid products are compacted, sorted by one int64
    (row, col) key (stable) and summed a (row, col) run at a time by
    torch.segment_reduce, which adds in a fixed order (no atomics), so two
    runs give the same bits. A group's keys and sums come to the host in one
    transfer. Group size: esc_group_rows over
    `device_budget_bytes` (default esc_budget_bytes(device)), in whole
    `row_chunk`s when given. The CSR is assembled on the host by
    coo_to_csr_arrays, so its structure is expand_csr's."""
    assert shape_a[1] == shape_b[0]
    dev = torch.device(device)
    n, m = shape_a[0], shape_b[1]
    va, ca = csr_to_ell_arrays(
        a_csr[0], a_csr[1], np.asarray(a_csr[2], dtype=dtype), shape_a)
    vb, cb = csr_to_ell_arrays(
        b_csr[0], b_csr[1], np.asarray(b_csr[2], dtype=dtype), shape_b)
    cnt_a = np.diff(a_csr[0]).astype(np.int32)
    cnt_b = np.pad(np.diff(b_csr[0]).astype(np.int32), (0, vb.shape[0] - shape_b[0]))
    Ka, Kb = va.shape[1], vb.shape[1]
    budget = esc_budget_bytes(dev) if device_budget_bytes is None else device_budget_bytes
    group = esc_group_rows(n, Ka, Kb, budget, row_chunk)
    # B is shared by every group: uploaded once
    vb_d = torch.as_tensor(vb, device=dev)
    cb_d = torch.as_tensor(cb, device=dev)
    cnt_b_d = torch.as_tensor(cnt_b, device=dev)
    keys_parts, vals_parts = [], []
    for r0 in range(0, n, group):
        r1 = min(r0 + group, n)
        ukeys, sums = _esc_group(
            torch.as_tensor(va[r0:r1], device=dev),
            torch.as_tensor(ca[r0:r1], device=dev).to(torch.int64),
            torch.as_tensor(cnt_a[r0:r1], device=dev), vb_d, cb_d, cnt_b_d, m)
        k = ukeys.numel()
        if k == 0:
            continue
        # one transfer a group: the keys, then the sums widened to f64
        # (exact) as their bit patterns
        packed = torch.cat([ukeys, sums.to(torch.float64).view(torch.int64)]).cpu().numpy()
        keys_parts.append(packed[:k] + r0 * m)
        vals_parts.append(packed[k:].view(np.float64))
    if keys_parts:
        keys_all = np.concatenate(keys_parts)
        vals_all = np.concatenate(vals_parts)
    else:
        keys_all = np.empty(0, np.int64)
        vals_all = np.empty(0, np.float64)
    ptr, idx, val = coo_to_csr_arrays(keys_all // m, keys_all % m, vals_all, (n, m))
    return ptr, idx, val, (n, m)


def masked_dense(a_csr, b_csr, shape_a, shape_b, *, threshold: float = 0.0,
                 dtype=None, device="cuda"):
    """SpGEMM through the densified operands and one torch.matmul in f32 on
    `device`; returns host CSR of the entries with |c| > threshold. For n·m
    that fits the card. TF32 must be off: its 10-bit products miss the
    tolerance the JAX package's own test holds this path to."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("masked_dense needs f32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    n, k = shape_a
    _, m = shape_b
    A = np.zeros((n, k), dtype=np.float32 if dtype is None else dtype)
    rows = np.repeat(np.arange(n), np.diff(a_csr[0]))
    A[rows, a_csr[1]] = a_csr[2]
    B = np.zeros((k, m), dtype=A.dtype)
    rows_b = np.repeat(np.arange(k), np.diff(b_csr[0]))
    B[rows_b, b_csr[1]] = b_csr[2]
    C = torch.matmul(torch.as_tensor(A, device=dev),
                     torch.as_tensor(B, device=dev)).to(torch.float32).cpu().numpy()
    C[np.abs(C) <= threshold] = 0.0
    r, c = np.nonzero(C)
    ptr, idx, val = coo_to_csr_arrays(r, c, C[r, c], (n, m))
    return ptr, idx, val, (n, m)
