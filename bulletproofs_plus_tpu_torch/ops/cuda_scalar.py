"""S1 wrapper: the batch verifier's scalar pass on GF(l), through
csrc/scalar_pass.cu.

`scalar_pass` launches S1 on CUDA tensors.  S1a (`scalar_proof_kernel`)
gives each proof `lanes_per_proof(rounds)` lanes of a warp and runs the
proof's program on them: a list of steps, each step one product, sum or
difference mod l a lane between slots in shared memory, and one step where
every value to invert, [e_1..e_k, y, y - 1], is inverted on a lane of its
own.  It writes each proof's dynamic scalars and a scratch table of the
factors its generator lanes need.  S1b (`scalar_lane_kernel`, a block a
generator lane, then a block for each base point) sums the lanes' terms over
the batch.  Its signature and outputs are those of the plain version,
models/verifier_kernels.py's `scalar_pass_plain`, which
`verifier_kernels.scalar_pass` takes for CPU tensors; every output is
canonical, so the two agree limb for limb.  Inputs are int64 radix-2^16
limbs, each limb below 2^16 (ops/field.py's layout).

`proof_program` builds S1a's program for a shape: the proof's products as a
graph (regrouped so that the longest chain is y^mn's k squarings and two
products), list-scheduled onto the lanes by longest path, its values given
slots by liveness.  A shape whose program and slots a block's shared memory
cannot hold at one proof a block (m above 1,024) keeps its slots in global
memory instead (`in_global`).
`scalar_pass_model` runs S1a's program and S1b in plain
Python on ops/scalar_model.py, word for word as the kernels run them (the
steps' loads before their stores, S1b's threads striding over the proofs and
the block's tree of sums); the CPU tests hold it against the plain version.
`mul_latency_probe` and `inv_latency_probe` (one warp, a chain of dependent
`sc_mul_l` or `sc_inv_l_warp`) count no launch.
"""

from __future__ import annotations

import functools
import heapq
from typing import NamedTuple

import numpy as np
import torch

from ..native import cuda
from . import scalar_model as SM

MAX_ROUNDS = 30  # S1_MAX_ROUNDS: mn = 2^rounds, and rounds + 2 values to invert fit in a warp
WARP = 32  # S1a's block: one warp, 32 / lanes_per_proof proofs
MIN_PROOF_LANES = 8
MAX_SLOTS = 1 << 30  # S1_MAX_SLOTS: an operation's slot indices have 30 bits
OP_SHIFT = 30  # an operation's third word: dst | op << OP_SHIFT
MAX_SMEM = 232448  # S1_MAX_SMEM: the shared memory a block may use on this card (227 KB)
LANE_THREAD_CHOICES = (32, 64, 128, 256)  # S1b's block sizes
COL_A, COL_D, COL_C, COL_H, COL_CHSQ = range(5)  # scratch columns, then y^-(2^b), G_j, w d1_k
OP_NOP, OP_MUL, OP_ADD, OP_SUB = range(4)  # an operation's kind; in the inversion step OP_MUL inverts
SLOT_ZERO, SLOT_ONE, SLOT_TWO_N_1 = range(3)  # constants, then y, z, e, w, r1, s1, e_1..e_k, d1, minimum values
IN_Y, IN_Z, IN_E, IN_W, IN_R1, IN_S1 = range(3, 9)
IN_FIXED = 9


def scratch_columns(rounds: int, m: int, deg: int) -> int:
    return COL_CHSQ + 2 * rounds + m + deg


def lane_threads(batch: int) -> int:
    """S1b's threads a block: the batch rounded up to a power of two, from 32 to 256."""
    return next((t for t in LANE_THREAD_CHOICES if t >= batch), LANE_THREAD_CHOICES[-1])


def lanes_per_proof(rounds: int) -> int:
    """S1a's lanes a proof: a power of two that holds the rounds + 2 values to invert, at least 8."""
    return max(MIN_PROOF_LANES, 1 << (rounds + 1).bit_length())


def check_shape(batch: int, rounds: int, m: int, bit_length: int, max_mn: int) -> None:
    """What S1 takes: mn = m * bit_length = 2^rounds, both powers of two, at most 2^MAX_ROUNDS."""
    mn = m * bit_length
    if batch < 1:
        raise ValueError("scalar_pass: expected a non-empty batch")
    if m & (m - 1) or bit_length & (bit_length - 1) or not 1 <= bit_length <= 64 or rounds > MAX_ROUNDS:
        raise ValueError(f"scalar_pass: m {m} and bit length {bit_length} must be powers of two, "
                         f"the bit length at most 64, rounds at most {MAX_ROUNDS}")
    if mn != 1 << rounds:
        raise ValueError("mn must be 2^rounds")
    if max_mn < mn:
        raise ValueError(f"scalar_pass: max_mn {max_mn} below mn {mn}")


# ---------------------------------------------------------------------------
# S1a's program
# ---------------------------------------------------------------------------


class Program(NamedTuple):
    lanes: int  # lanes a proof
    words: np.ndarray  # (steps, lanes, 3) uint32: slots a, b, then dst | op << 30
    inv_step: int  # the step that inverts
    slots: int  # 32-byte slots a proof in shared memory
    outs: np.ndarray  # (m + 3 + 2k + columns,) int32: the slot of each output, in the kernel's store order
    products: int  # products mod l a proof, the inversion's not counted
    mul_steps: int  # steps with a product: the proof's chain of products beside the inversion


class _Graph:
    """The proof's values: inputs in their slots, then nodes (op, a, b)."""

    def __init__(self, n_inputs: int):
        self.ops: list = [None] * n_inputs
        self.inverts: list = []

    def _node(self, op, a, b=SLOT_ZERO):
        self.ops.append((op, a, b))
        return len(self.ops) - 1

    def mul(self, a, b):
        return self._node(OP_MUL, a, b)

    def add(self, a, b):
        return self._node(OP_ADD, a, b)

    def sub(self, a, b):
        return self._node(OP_SUB, a, b)

    def inv(self, a):
        node = self._node("inv", a)
        self.inverts.append(node)
        return node

    def tree(self, op, values):
        """A balanced tree of `op` over `values` (at least one)."""
        values = list(values)
        while len(values) > 1:
            values = [op(values[i], values[i + 1]) if i + 1 < len(values) else values[i]
                      for i in range(0, len(values), 2)]
        return values[0]


def _proof_graph(rounds: int, m: int, deg: int):
    """S1a's values for one proof and its outputs in store order.  The JAX
    program's terms, regrouped (every output is a canonical residue, so any
    grouping gives the same limbs):
      h_base = w r1 y s1 + w e^2 (y^mn (y V + X) - X) where V = z zs + sum_j z^(2(j+1)) min_j,
               X = y (y - 1)^-1 (z^2 - z), zs = (2^n - 1) sum_j z^(2(j+1));
      commit_j = -(y^mn (w e^2 y z^(2(j+1)))),  G_j = y^mn (w e^2 z^(2(j+1)));
      A = (w e r1) prod_j e_j^-1, D = (w e s1) prod_j e_j^-1, C = w e^2 z."""
    k = rounds
    g = _Graph(IN_FIXED + k + deg + m)
    es = list(range(IN_FIXED, IN_FIXED + k))
    d1 = list(range(IN_FIXED + k, IN_FIXED + k + deg))
    mins = list(range(IN_FIXED + k + deg, IN_FIXED + k + deg + m))
    y, z, e, w, r1, s1 = IN_Y, IN_Z, IN_E, IN_W, IN_R1, IN_S1

    ym1 = g.sub(y, SLOT_ONE)
    e_inv = [g.inv(x) for x in es]
    y_inv, y1_inv = g.inv(y), g.inv(ym1)

    e_sq = g.mul(e, e)
    we = g.mul(w, e)
    wesq = g.mul(w, e_sq)
    a_s = g.sub(SLOT_ZERO, wesq)
    chsq = [g.mul(x, x) for x in es]
    li = [g.mul(a_s, c) for c in chsq]
    ri = [g.mul(a_s, g.mul(x, x)) for x in e_inv]
    yinv = [y_inv][:k]  # y^-(2^b), b < k
    for _ in range(1, k):
        yinv.append(g.mul(yinv[-1], yinv[-1]))
    ynm = y
    for _ in range(k):
        ynm = g.mul(ynm, ynm)

    zsq = g.mul(z, z)
    zp = [zsq]  # z^(2(j+1)): squarings of an earlier one where j + 1 is even
    for j in range(1, m):
        zp.append(g.mul(zp[(j + 1) // 2 - 1], zp[(j + 1) // 2 - 1]) if (j + 1) % 2 == 0 else g.mul(zp[-1], zsq))
    wy = g.mul(wesq, y)
    commit = [g.sub(SLOT_ZERO, g.mul(ynm, g.mul(wy, p))) for p in zp]
    gcol = [g.mul(ynm, g.mul(wesq, p)) for p in zp]
    zs = g.mul(g.tree(g.add, zp), SLOT_TWO_N_1)
    v = g.add(g.mul(z, zs), g.tree(g.add, [g.mul(p, mv) for p, mv in zip(zp, mins)]))
    x = g.mul(g.mul(y, y1_inv), g.sub(zsq, z))
    bracket = g.sub(g.mul(ynm, g.add(g.mul(y, v), x)), x)
    h = g.add(g.mul(w, g.mul(g.mul(r1, y), s1)), g.mul(wesq, bracket))
    wr, ws = g.mul(we, r1), g.mul(we, s1)
    if k:
        chinv = g.tree(g.mul, e_inv)
        col_a, col_d = g.mul(wr, chinv), g.mul(ws, chinv)
    else:  # no round challenges: their product is 1
        col_a, col_d = wr, ws
    col_c = g.mul(wesq, z)
    wd = [g.mul(w, d) for d in d1]

    outs = (commit + [g.sub(SLOT_ZERO, we), g.sub(SLOT_ZERO, w), a_s] + li + ri
            + [col_a, col_d, col_c, h] + chsq + yinv + gcol + wd)
    return g, outs


# longest-path weights: a sum is some twentieth of a product; the inversion some twenty products
_WEIGHT = {OP_MUL: 1.0, OP_ADD: 0.05, OP_SUB: 0.05, "inv": 20.0}


def smem_bytes(prog: Program, rounds: int, m: int, deg: int) -> int:
    """S1a's shared memory a block for the program and its slots: the
    program's words and output slots (rounded up to 16 bytes), then
    32 / lanes proofs' slots of 32 bytes."""
    words = prog.words.size + m + 3 + 2 * rounds + scratch_columns(rounds, m, deg)
    return 4 * ((words + 3) & ~3) + (WARP // prog.lanes) * prog.slots * 32


def in_global(prog: Program, rounds: int, m: int, deg: int) -> bool:
    """Whether S1a keeps this program's slots in global memory: a block's
    shared memory cannot hold them."""
    return smem_bytes(prog, rounds, m, deg) > MAX_SMEM


@functools.lru_cache(maxsize=64)
def proof_program(rounds: int, m: int, deg: int) -> Program:
    """S1a's program for a shape, at `lanes_per_proof(rounds)` lanes, or at
    32 (one proof a block) where the proofs of a block at that width do not
    fit its shared memory."""
    graph, outs = _proof_graph(rounds, m, deg)
    lanes = lanes_per_proof(rounds)
    prog = _schedule(graph, outs, rounds, m, deg, lanes)
    if in_global(prog, rounds, m, deg) and lanes < WARP:
        prog = _schedule(graph, outs, rounds, m, deg, WARP)
    if prog.slots > MAX_SLOTS:
        raise ValueError(f"scalar_pass: a proof of {rounds} rounds, m {m} and degree {deg} needs {prog.slots} "
                         f"slots; S1 indexes {MAX_SLOTS}")
    return prog


def _schedule(graph: _Graph, outs: list, rounds: int, m: int, deg: int, lanes: int) -> Program:
    """The graph's nodes in steps of at most `lanes`, each step the ready
    nodes of longest path to the outputs first; the inversions all in one
    step, as soon as their inputs are ready.  Slots: 0-2 the constants 0, 1
    and 2^n - 1, then the inputs, then the nodes', each freed after the step
    that last reads it (a step reads every operand before it writes) unless
    it is an output."""
    n_in = IN_FIXED + rounds + deg + m
    nodes = range(n_in, len(graph.ops))
    users: dict = {n: [] for n in range(len(graph.ops))}
    waiting = {}  # a node's operands not yet computed
    for n in nodes:
        srcs = {graph.ops[n][1], graph.ops[n][2]}
        for src in srcs:
            users[src].append(n)
        waiting[n] = sum(1 for src in srcs if src >= n_in)
    path = {}
    for n in reversed(nodes):
        path[n] = _WEIGHT[graph.ops[n][0]] + max((path[u] for u in users[n]), default=0.0)

    inverts = set(graph.inverts)
    ready = [(-path[n], n) for n in nodes if not waiting[n] and n not in inverts]
    heapq.heapify(ready)
    inv_ready = {n for n in inverts if not waiting[n]}
    steps, inv_step = [], -1
    while ready or inverts:
        if inverts and inv_ready == inverts:
            step, inv_step = sorted(inverts), len(steps)
            inverts = set()
        else:
            step = [heapq.heappop(ready)[1] for _ in range(min(lanes, len(ready)))]
        steps.append(step)
        for n in step:
            for u in users[n]:
                waiting[u] -= 1
                if not waiting[u]:
                    if u in inverts:
                        inv_ready.add(u)
                    else:
                        heapq.heappush(ready, (-path[u], u))
    assert sum(len(step) for step in steps) == len(nodes)

    last = {}
    for s, step in enumerate(steps):
        for n in step:
            for src in graph.ops[n][1:]:
                last[src] = s
    for n in outs:
        last[n] = len(steps)
    slot = {n: n for n in range(n_in)}
    free: list = []
    frees: dict = {}
    for n, s in last.items():
        if n != SLOT_ZERO:
            frees.setdefault(s, []).append(n)
    for n in range(SLOT_ONE, n_in):  # slot 0 stays 0: the idle lanes' operand
        if n not in last:
            heapq.heappush(free, n)
    top = n_in
    words = np.zeros((len(steps), lanes, 3), dtype=np.uint32)
    for s, step in enumerate(steps):
        for n in frees.get(s, []):
            heapq.heappush(free, slot[n])
        for lane, n in enumerate(step):
            if free:
                slot[n] = heapq.heappop(free)
            else:
                slot[n], top = top, top + 1
            op, a, b = graph.ops[n]
            words[s, lane] = (slot[a], slot[b], slot[n] | (OP_MUL if op == "inv" else op) << OP_SHIFT)
    products = sum(1 for n in nodes if graph.ops[n][0] == OP_MUL)
    mul_steps = sum(1 for step in steps if any(graph.ops[n][0] == OP_MUL for n in step))
    return Program(lanes, words, inv_step, top, np.asarray([slot[n] for n in outs], dtype=np.int32), products,
                   mul_steps)


@functools.lru_cache(maxsize=64)
def _program_on(rounds: int, m: int, deg: int, device: torch.device) -> torch.Tensor:
    """The program's words, then its output slots, as one int32 tensor on `device`."""
    prog = proof_program(rounds, m, deg)
    flat = np.concatenate([prog.words.reshape(-1).view(np.int32), prog.outs])
    return torch.as_tensor(flat, device=device)


# ---------------------------------------------------------------------------
# The wrapper and the probes
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor, what: str, shape: tuple):
    """A kernel input of `shape` (batch, [items,] 16) and its row stride in
    limbs: its rows may lie apart, as the replay's views of one tensor do,
    with each row's items contiguous; another layout is copied first."""
    if t.device.type != "cuda" or t.dtype != torch.int64 or tuple(t.shape) != shape:
        cuda.require(t, what, shape)  # raises with the reason
    if t.stride(-1) != 1 or (len(shape) == 3 and shape[1] > 1 and t.stride(1) != 16) or t.stride(0) < t[0].numel():
        t = t.contiguous()
    return t, max(t.stride(0), 16)


def scalar_pass(y, z, round_es, e, weight, r1, s1, d1, min_values, *, m: int, bit_length: int, max_mn: int):
    """S1 on CUDA tensors: the plain version's inputs and outputs, two
    launches on the current stream, counted once as `scalar_pass`.  The
    outputs are views of one buffer.  The values to invert (y, y - 1 and the
    round challenges) are taken canonical, below l, as the replay gives
    them."""
    B = y.shape[0]
    rounds, deg = round_es.shape[1], d1.shape[1]
    check_shape(B, rounds, m, bit_length, max_mn)
    inputs = {"y": (y, ()), "z": (z, ()), "round_es": (round_es, (rounds,)), "e": (e, ()), "weight": (weight, ()),
              "r1": (r1, ()), "s1": (s1, ()), "d1": (d1, (deg,)), "min_values": (min_values, (m,))}
    ins = [_rows(t, f"scalar_pass {name}", (B,) + inner + (16,)) for name, (t, inner) in inputs.items()]
    dev = y.device
    if any(t.device != dev for t, _ in ins):
        raise ValueError("scalar_pass: expected every input on one device")
    prog = proof_program(rounds, m, deg)
    words = _program_on(rounds, m, deg, dev)
    shapes = ((max_mn, 16), (max_mn, 16), (deg, 16), (16,), (B, m, 16), (B, 16), (B, 16), (B, 16), (B, rounds, 16),
              (B, rounds, 16))
    sizes = [int(np.prod(shape)) for shape in shapes]
    outs = [part.view(shape) for part, shape in zip(torch.empty(sum(sizes), dtype=torch.int64, device=dev)
                                                    .split(sizes), shapes)]
    scratch = torch.empty((scratch_columns(rounds, m, deg), B, 8), dtype=torch.int32, device=dev)
    per_block = WARP // prog.lanes
    slots = (torch.empty((-(-B // per_block) * per_block, prog.slots, 8), dtype=torch.int32, device=dev)
             if in_global(prog, rounds, m, deg) else None)
    gi, hi, gb, hb, commit, a1_s, b_s, a_s, li_s, ri_s = outs
    with torch.cuda.device(dev):
        status = cuda.lib("scalar").bppt_scalar_pass(
            *(t.data_ptr() for t, _ in ins), *(stride for _, stride in ins), B, rounds, m, bit_length, deg, max_mn,
            commit.data_ptr(), a1_s.data_ptr(), b_s.data_ptr(), a_s.data_ptr(), li_s.data_ptr(), ri_s.data_ptr(),
            gi.data_ptr(), hi.data_ptr(), gb.data_ptr(), hb.data_ptr(), scratch.data_ptr(),
            None if slots is None else slots.data_ptr(), words.data_ptr(), len(prog.words), prog.inv_step,
            prog.slots, prog.lanes, lane_threads(B),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda.check("scalar", status, "scalar_pass")
    cuda.launches["scalar_pass"] += 1
    return gi, hi, gb, hb, commit, a1_s, b_s, a_s, li_s, ri_s


def _probe(entry: str, x: torch.Tensor, iters: int) -> torch.Tensor:
    cuda.require(x, f"{entry} input", (32, 16))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = getattr(cuda.lib("scalar"), entry)(x.data_ptr(), out.data_ptr(), iters,
                                                    torch.cuda.current_stream().cuda_stream)
    cuda.check("scalar", status, entry)
    return out


def mul_latency_probe(x: torch.Tensor, iters: int) -> torch.Tensor:
    """One warp, lane t a chain of `iters` dependent products acc * x[t]
    from acc = x[t] ((32, 16) int64 limbs on a CUDA device): x^(iters + 1)
    mod l.  Counts no launch."""
    return _probe("bppt_scalar_latency", x, iters)


def inv_latency_probe(x: torch.Tensor, iters: int) -> torch.Tensor:
    """One warp, lane t a chain of `iters` dependent inversions of x[t]
    ((32, 16) canonical int64 limbs on a CUDA device): x^((-1)^iters) mod l,
    0 for 0.  Counts no launch."""
    return _probe("bppt_scalar_inv_latency", x, iters)


# ---------------------------------------------------------------------------
# The kernels' programs in Python, on ops/scalar_model.py
# ---------------------------------------------------------------------------


def _words(limbs) -> list:
    return [int(limbs[2 * k]) | int(limbs[2 * k + 1]) << 16 for k in range(8)]


def _limbs(words) -> list:
    return [v for w in words for v in (w & 0xFFFF, w >> 16)]


def _small(v: int) -> list:
    return [v] + [0] * 7


def _proof_model(prog: Program, y, z, es, e, w, r1, s1, d1, mins, n: int):
    """S1a's lanes for one proof, on 8-word values: every step's lanes load
    their operands, then store their results; in the inversion step a zero
    among the values inverted makes every inverse 0 (the lanes' vote).
    Returns the outputs in store order."""
    two_n_1 = (1 << n) - 1
    slots = [None] * prog.slots
    values = [_small(0), _small(1), [two_n_1 & SM.M32, two_n_1 >> 32] + [0] * 6, y, z, e, w, r1, s1]
    for i, v in enumerate(values + list(es) + list(d1) + list(mins)):
        slots[i] = v
    for s, step in enumerate(prog.words):
        loaded = [(int(w2) >> OP_SHIFT, slots[int(w0)], slots[int(w1)], int(w2) & (MAX_SLOTS - 1))
                  for w0, w1, w2 in step]
        if s == prog.inv_step:
            poison = any(op and not any(a) for op, a, _, _ in loaded)
            results = [_small(0) if poison else SM.inv_l(a) for _, a, _, _ in loaded]
        else:
            fn = {OP_NOP: lambda a, b: None, OP_MUL: SM.mul_l, OP_ADD: SM.add_l, OP_SUB: SM.sub_l}
            results = [fn[op](a, b) for op, a, b, _ in loaded]
        for (op, _, _, dst), r in zip(loaded, results):
            if op:
                slots[dst] = r
    return [slots[int(o)] for o in prog.outs]


def _block_sum(per_thread: list) -> list:
    """The block's tree of modular sums over its threads' values."""
    vals = list(per_thread)
    s = len(vals) >> 1
    while s:
        for t in range(s):
            vals[t] = SM.add_l(vals[t], vals[t + s])
        s >>= 1
    return vals[0]


def _lane_model(cols: list, i: int, rounds: int, n: int, threads: int):
    """S1b's block for lane i < mn: (g_i, h_i) summed over the batch."""
    col_yinv, col_g = COL_CHSQ + rounds, COL_CHSQ + 2 * rounds
    two_k = [0] * 8
    two_k[(i % n) >> 5] = 1 << ((i % n) & 31)
    g, h = [_small(0)] * threads, [_small(0)] * threads
    for t in range(threads):
        for b in range(t, len(cols), threads):
            c = cols[b]
            yi = pi = pr = None
            for k in range(rounds):
                chsq = c[COL_CHSQ + rounds - 1 - k]
                if (i >> k) & 1:
                    yi = c[col_yinv + k] if yi is None else SM.mul_l(yi, c[col_yinv + k])
                    pi = chsq if pi is None else SM.mul_l(pi, chsq)
                else:
                    pr = chsq if pr is None else SM.mul_l(pr, chsq)
            u = c[COL_A]
            if yi is not None:
                u = SM.mul_l(u, yi)
            if pi is not None:
                u = SM.mul_l(u, pi)
            g[t] = SM.add_l(g[t], SM.add_l(u, c[COL_C]))
            h[t] = SM.sub_l(h[t], c[COL_C])
            u = c[COL_D] if pr is None else SM.mul_l(c[COL_D], pr)
            h[t] = SM.add_l(h[t], u)
            u = SM.mul_l(c[col_g + i // n], two_k)
            if yi is not None:
                u = SM.mul_l(u, yi)
            h[t] = SM.sub_l(h[t], u)
    return _block_sum(g), _block_sum(h)


def _column_sum(cols: list, col: int) -> list:
    """One thread's sum of a scratch column over its proofs."""
    acc = _small(0)
    for c in cols:
        acc = SM.add_l(acc, c[col])
    return acc


def scalar_pass_model(y, z, round_es, e, weight, r1, s1, d1, min_values, *, m: int, bit_length: int, max_mn: int):
    """S1's programs on numpy int64 limb arrays (the plain version's shapes):
    S1a proof by proof, then S1b block by block at the threads the wrapper
    picks.  Returns the plain version's ten outputs as numpy int64 limbs."""
    B, rounds = y.shape[0], round_es.shape[1]
    deg = d1.shape[1]
    check_shape(B, rounds, m, bit_length, max_mn)
    mn, threads = m * bit_length, lane_threads(B)
    prog = proof_program(rounds, m, deg)
    n_dyn = m + 3 + 2 * rounds
    per_proof = [
        _proof_model(prog, _words(y[b]), _words(z[b]), [_words(v) for v in round_es[b]], _words(e[b]),
                     _words(weight[b]), _words(r1[b]), _words(s1[b]), [_words(v) for v in d1[b]],
                     [_words(v) for v in min_values[b]], bit_length)
        for b in range(B)
    ]
    cols = [p[n_dyn:] for p in per_proof]
    lanes = [_lane_model(cols, i, rounds, bit_length, threads) for i in range(mn)]
    zero = _small(0)
    gi = [g for g, _ in lanes] + [zero] * (max_mn - mn)
    hi = [h for _, h in lanes] + [zero] * (max_mn - mn)
    col_w = COL_CHSQ + 2 * rounds + m
    gb = [_block_sum([_column_sum(cols[t::threads], col_w + k) for t in range(threads)]) for k in range(deg)]
    hb = _block_sum([_column_sum(cols[t::threads], COL_H) for t in range(threads)])

    def arr(values, shape):
        return np.asarray([_limbs(v) for v in values], dtype=np.int64).reshape(shape + (16,))

    def dyn(lo, count):
        return [v for p in per_proof for v in p[lo:lo + count]]

    return (arr(gi, (max_mn,)), arr(hi, (max_mn,)), arr(gb, (deg,)), arr([hb], (1,))[0],
            arr(dyn(0, m), (B, m)), arr(dyn(m, 1), (B,)), arr(dyn(m + 1, 1), (B,)), arr(dyn(m + 2, 1), (B,)),
            arr(dyn(m + 3, rounds), (B, rounds)), arr(dyn(m + 3 + rounds, rounds), (B, rounds)))
