"""Device admission's pull: the mailbox, its CUDA kernel and the plain install.

The port of the in-loop ``io_callback`` pull of
``handwritten_math_ocr_api_tpu/decode/continuous.py`` (``decode_segment``'s
``admit_pull`` and ``ContinuousDecoder._device_pull``); it replaces no
Pallas kernel. The host stages a request's cross K/V into a row of a
staging pool on the device, then publishes an entry (pool row, slot,
sequence number) into a ``Mailbox``; at the head of every step of a
device-admission segment ``admission_pull`` takes at most one published
entry, in sequence order, and installs it: the slot's cross K/V rows of
every layer from the pool row, its small state reset (prev SOS, pos 0,
active, not finished, tokens PAD, log-prob sum and count 0), its
pushdown state cleared, and the entry's sequence number recorded as the
slot's occupant. An entry the host cancelled is skipped. The kernel writes
back which segment and step took each entry (the record), which the host
reads once a later report has landed.

On the card the mailbox lives in mapped pinned host memory
(``cudaHostAllocMapped``) and ``admission_pull`` launches the kernel of
``csrc/admission_pull.cu`` (one block, counted; its header sets out the
single-writer protocol). On the host the mailbox is a numpy array and
``admission_pull`` takes the plain install, ``admission_pull_plain``,
which the CPU tests use and which reads the same fields in the same order.
``admission_pull_plain`` also runs on CUDA tensors (it reads the mailbox
and the cursor on the host), so that a check on the card can hold the
kernel against it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.config import PAD_ID, SOS_ID
from . import _build

_ENTRY = "admission_pull"
FIELDS = 8
SEQ, POOL, SLOT, CANCEL, DONE, SEG, STEP = range(7)


class Mailbox:
    """A ring of ``capacity`` entries of eight int64 fields (see
    ``csrc/admission_pull.cu``) and the kernel's read position ``cursor``
    (an int64 tensor on ``device``). On CUDA the ring is mapped pinned host
    memory that the kernel reads and writes; ``entries`` is its numpy view.
    The host writes SEQ, POOL, SLOT and CANCEL, the pull writes DONE, SEG,
    STEP and the cursor."""

    def __init__(self, capacity: int, device) -> None:
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.next_seq = 1  # the next entry's sequence number
        self._host = None
        n = self.capacity * FIELDS
        if self.device.type == "cuda":
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            _build.check(_build.library().admission_mailbox_alloc(
                n * 8, ctypes.addressof(host), ctypes.addressof(dev)),
                "admission_mailbox_alloc")
            self._host = host.value
            self.dev_ptr = dev.value
            buf = (ctypes.c_int64 * n).from_address(self._host)
            self.entries = np.frombuffer(buf, np.int64).reshape(
                self.capacity, FIELDS)
        else:
            self.entries = np.zeros((self.capacity, FIELDS), np.int64)
            self.dev_ptr = None
        self.cursor = torch.zeros((1,), dtype=torch.int64, device=self.device)

    def _row(self, seq: int) -> np.ndarray:
        return self.entries[(seq - 1) % self.capacity]

    def full(self) -> bool:
        """The ring entry of the next sequence number still holds an entry
        the pull has not consumed."""
        old = self.next_seq - self.capacity
        return old >= 1 and not self.consumed(old)

    def reserve(self) -> Optional[int]:
        """The next sequence number, or None while the ring is ``full``."""
        if self.full():
            return None
        self.next_seq += 1
        return self.next_seq - 1

    def publish(self, seq: int, pool: int, slot: int) -> None:
        """Write entry ``seq`` (reserved, in sequence order), its sequence
        number last: the pull may take it from then on."""
        row = self._row(seq)
        row[POOL] = pool
        row[SLOT] = slot
        row[SEQ] = seq

    def cancel(self, seq: int) -> None:
        """Mark entry ``seq`` cancelled: a pull that has not taken it skips
        it (it may be written before or after the entry is published)."""
        self._row(seq)[CANCEL] = seq

    def consumed(self, seq: int) -> bool:
        """The pull has taken or skipped entry ``seq``."""
        return int(self._row(seq)[DONE]) == seq

    def taken(self, seq: int) -> Optional[tuple]:
        """(segment, step) that took entry ``seq``; None while it is not
        consumed or when it was skipped."""
        row = self._row(seq)
        if int(row[DONE]) != seq or int(row[SEG]) < 0:
            return None
        return int(row[SEG]), int(row[STEP])

    def close(self) -> None:
        """Free the mapped host memory (idempotent). The caller makes sure
        that no queued pull still reads it."""
        if self._host is not None:
            self.entries = None
            _build.check(_build.library().admission_mailbox_free(self._host),
                         "admission_mailbox_free")
            self._host = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the process frees it
            pass


class PullState(NamedTuple):
    """What a pull writes: the small state's (S,) tensors and (S, T)
    tokens, the pushdown rows (``con``: stack (S, depth), ptr, mode, needs,
    sup, or None), and the slots' occupants (S,) int64."""

    prev: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor
    finished: torch.Tensor
    tokens: torch.Tensor
    lp_sum: torch.Tensor
    count: torch.Tensor
    con: Optional[Sequence[torch.Tensor]]
    occupant: torch.Tensor


def admission_pull_plain(mailbox: Mailbox, pool_k, pool_v, cross_k, cross_v,
                         state: PullState, seg: int, step: int,
                         max_scan: Optional[int] = None) -> Optional[int]:
    """Take at most one published entry and install it, as the kernel does:
    entries are read in sequence order from the cursor, cancelled ones
    skipped (recorded with segment -1). ``pool_k``/``pool_v`` (P, L, ...)
    and ``cross_k``/``cross_v`` (L, S, ...) of one layout behind the row.
    Returns the taken entry's sequence number, or None."""
    cap = mailbox.capacity
    scan = cap if max_scan is None else max_scan
    P, S = pool_k.shape[0], cross_k.shape[1]
    c = int(mailbox.cursor[0])
    taken = None
    for _ in range(scan):
        row = mailbox.entries[c % cap]
        seq = int(row[SEQ])
        if seq != c + 1:
            break
        c += 1
        p, slot = int(row[POOL]), int(row[SLOT])
        if int(row[CANCEL]) == seq or not (0 <= p < P and 0 <= slot < S):
            row[SEG], row[STEP], row[DONE] = -1, step, seq
            continue
        taken = (seq, p, slot)
        break
    mailbox.cursor.fill_(c)
    if taken is None:
        return None
    seq, p, slot = taken
    cross_k[:, slot] = pool_k[p]
    cross_v[:, slot] = pool_v[p]
    state.prev[slot] = SOS_ID
    state.pos[slot] = 0
    state.active[slot] = True
    state.finished[slot] = False
    state.tokens[slot] = PAD_ID
    state.lp_sum[slot] = 0.0
    state.count[slot] = 0
    if state.con is not None:
        for t in state.con:
            t[slot] = 0
    state.occupant[slot] = seq
    row = mailbox.entries[(seq - 1) % cap]
    row[SEG], row[STEP], row[DONE] = seg, step, seq
    return seq


def _check(mailbox, pool_k, pool_v, cross_k, cross_v, state):
    P, L = pool_k.shape[:2]
    S = cross_k.shape[1]
    if (cross_k.shape[0] != L or tuple(pool_k.shape[2:])
            != tuple(cross_k.shape[2:])):
        raise ValueError(f"pool rows {tuple(pool_k.shape)} do not fit "
                         f"cross rows {tuple(cross_k.shape)}")
    if pool_v.shape != pool_k.shape or cross_v.shape != cross_k.shape:
        raise ValueError("K and V pools or caches differ in shape")
    T = state.tokens.shape[1]
    if tuple(state.tokens.shape) != (S, T):
        raise ValueError(f"tokens {tuple(state.tokens.shape)}, expected "
                         f"({S}, T)")
    return P, L, S, T


def admission_pull(mailbox: Mailbox, pool_k, pool_v, cross_k, cross_v,
                   state: PullState, seg: int, step: int,
                   max_scan: Optional[int] = None) -> None:
    """``admission_pull_plain``'s function. On CUDA tensors one launch of
    the pull kernel (counted), which reads the mailbox on the card and
    returns nothing to the host; on CPU tensors the plain install."""
    if not cross_k.is_cuda:
        admission_pull_plain(mailbox, pool_k, pool_v, cross_k, cross_v,
                             state, seg, step, max_scan)
        return
    if mailbox.dev_ptr is None:
        raise ValueError("the mailbox is not on the card")
    P, L, S, T = _check(mailbox, pool_k, pool_v, cross_k, cross_v, state)
    dev, dt = cross_k.device, cross_k.dtype
    row = cross_k[0, 0].numel() * cross_k.element_size()
    if row % 16:
        raise ValueError(f"the pull copies 16-byte vectors: a cross row of "
                         f"{row} bytes")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("cross_k", cross_k), ("cross_v", cross_v)):
        _build.require(t, name, dtype=dt, device=dev, aligned=True)
    i32, b = torch.int32, torch.bool
    for name, t, dtype, shape in (
            ("prev", state.prev, i32, (S,)), ("pos", state.pos, i32, (S,)),
            ("active", state.active, b, (S,)),
            ("finished", state.finished, b, (S,)),
            ("tokens", state.tokens, i32, (S, T)),
            ("lp_sum", state.lp_sum, torch.float32, (S,)),
            ("count", state.count, i32, (S,)),
            ("occupant", state.occupant, torch.int64, (S,)),
            ("cursor", mailbox.cursor, torch.int64, (1,))):
        _build.require(t, name, dtype=dtype, shape=shape, device=dev)
    con_ptrs, depth = [None] * 5, 0
    if state.con is not None:
        stack = state.con[0]
        depth = stack.shape[1]
        for name, t, dtype, shape in zip(
                ("con_stack", "con_ptr", "con_mode", "con_needs", "con_sup"),
                state.con, (i32, i32, i32, b, b),
                ((S, depth), (S,), (S,), (S,), (S,))):
            _build.require(t, name, dtype=dtype, shape=shape, device=dev)
        con_ptrs = [t.data_ptr() for t in state.con]
    scan = mailbox.capacity if max_scan is None else max_scan
    code = _build.library().admission_pull(
        mailbox.dev_ptr, mailbox.capacity, mailbox.cursor.data_ptr(), scan,
        pool_k.data_ptr(), pool_v.data_ptr(), cross_k.data_ptr(),
        cross_v.data_ptr(), L, S, P, row, state.prev.data_ptr(),
        state.pos.data_ptr(), state.active.data_ptr(),
        state.finished.data_ptr(), state.tokens.data_ptr(), T,
        state.lp_sum.data_ptr(), state.count.data_ptr(), con_ptrs[0], depth,
        *con_ptrs[1:], state.occupant.data_ptr(), int(seg), int(step),
        SOS_ID, PAD_ID, _build.stream_handle(dev))
    _build.check(code, _ENTRY)
    _build.count(admission_pull)


admission_pull.launches = 0
