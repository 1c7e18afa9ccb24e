"""What a run drives: one class a kind of traffic, named by the mix's
`entry`.  Each builds its inputs from the seed in set-up, warms up on the
cell's own shapes, runs one call of the window in `step`, and hands what
the window produced to the comparison (check.py).  The port
(bulletproofs_plus_tpu_torch) is the system under test; everything else
here is the benchmark's own.

  * verify_stream: blocks decoded from wire bytes, then
    `RangeProof.verify_batches_pipelined`, `blocks_per_call` blocks a call;
    a refused call is verified again block by block, so that every block
    gets a verdict of its own
  * prove_calls: the wallet's commitments (`PedersenGens.commit`), then
    `RangeProof.prove_batch_with_rng` and `to_bytes`, a call a batch
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

from . import inputs, work_model
from ..reference.rng import StreamRng


class Spans:
    """Harness spans around the calls into each layer: durations by name,
    and a `torch.profiler.record_function` of the same name when traced."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.times = {}

    @contextmanager
    def __call__(self, name: str):
        if self.traced:
            from torch.profiler import record_function

            with record_function(f"portbench.{name}"):
                t0 = time.perf_counter()
                yield
        else:
            t0 = time.perf_counter()
            yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)


class Entry:
    def __init__(self, seed: int, config: dict, traffic: dict, device: str, spans: Spans):
        import bulletproofs_plus_tpu_torch as bp

        self.bp, self.seed, self.config, self.traffic = bp, seed, config, traffic
        self.device, self.spans = device, spans
        self.label = traffic["label"].encode()
        self.pc = bp.create_pedersen_gens_with_extension_degree(bp.ExtensionDegree(config["extension_degree"]))
        self.params = bp.RangeParameters.init(config["bits"], config["max_aggregation"], self.pc)
        self.counts = {"calls": 0, "commitments": 0}
        self.least_s = 0.0  # the work model's least device time of the window's work

    def statements(self, outs, seeded: bool):
        """The wallet's side: commitments, statements and witnesses of `outs`."""
        bp = self.bp
        statements = [
            bp.RangeStatement.init(self.params, [self.pc.commit(v, bl) for v, bl in zip(o.values, o.blindings)],
                                   list(o.promises), o.nonce if seeded else None)
            for o in outs
        ]
        witnesses = [
            bp.RangeWitness.init([bp.CommitmentOpening(v, bl) for v, bl in zip(o.values, o.blindings)])
            for o in outs
        ]
        return statements, witnesses

    def prove(self, statements, witnesses, rng):
        bp = self.bp
        transcripts = [bp.Transcript(self.label) for _ in statements]
        return bp.RangeProof.prove_batch_with_rng(transcripts, statements, witnesses, rng, device=self.device)


class VerifyStream(Entry):
    """A node's stream: a pool of proofs made through the port's prover in
    set-up, served as wire bytes block by block, `blocks_per_call` blocks a
    `verify_batches_pipelined` call."""

    def setup(self) -> None:
        traffic, config = self.traffic, self.config
        self.pool = []  # per group: [(proof bytes, [commitment bytes], promises)]
        for k, (group, outs) in enumerate(zip(traffic["pool"], inputs.pool_outputs(self.seed, traffic, config))):
            wire = []
            step = group["prove_batch"]
            for start in range(0, len(outs), step):
                statements, witnesses = self.statements(outs[start : start + step], traffic.get("seed_nonce", False))
                rng = StreamRng(self.seed, -(1 + 1000 * k + start // step))
                for proof, st, o in zip(self.prove(statements, witnesses, rng), statements, outs[start : start + step]):
                    wire.append((proof.to_bytes(), list(st.commitments_compressed), list(o.promises)))
            self.pool.append(wire)
        self.per_call = traffic.get("blocks_per_call", 1)
        self.outcomes = []  # (block numbers of a call into the port, its outcome)
        every = traffic.get("tamper_every", 0)
        for call in range(max(0, every - 2), every) if every else range(2):  # the last one refused
            self._call(range(call * self.per_call, (call + 1) * self.per_call), inputs.WARM, record=False)
        every = traffic["decode_every"]
        self.kept_offset = inputs.sample(self.seed, every, 1, inputs.BLOCK)[0]
        self.kept = {}  # block number -> decoded (statements, proofs), one in decode_every, for the decode check

    def wire(self, block):
        """The block as it arrives: each proof's bytes (the tampered one
        altered), its commitments' encodings and its promises."""
        out = []
        for pos, (group, index) in enumerate(block.proofs):
            proof, commitments, promises = self.pool[group][index]
            if pos == block.tampered:
                proof = inputs.tamper(proof, self.config["extension_degree"], self.traffic["tamper_field"])
            out.append((proof, commitments, promises))
        return out

    def decode(self, wire):
        """A node's decode: proofs from bytes, commitments decompressed,
        statements without seed nonces, a fresh transcript a proof."""
        bp = self.bp
        from bulletproofs_plus_tpu_torch.ops import host_ristretto as hr

        transcripts, statements, proofs = [], [], []
        for proof, commitments, promises in wire:
            proofs.append(bp.RangeProof.from_bytes(proof))
            points = [hr.decompress(c) for c in commitments]
            if any(p is None for p in points):
                raise bp.InvalidArgument("commitment is not a canonical point encoding")
            statements.append(bp.RangeStatement.init(self.params, points, list(promises)))
            transcripts.append(bp.Transcript(self.label))
        return transcripts, statements, proofs

    def _call(self, numbers, key: int, record: bool = True) -> None:
        wires = [self.wire(inputs.block(self.seed, self.traffic, n, key)) for n in numbers]
        decoded = []
        for n, w in zip(numbers, wires):
            with self.spans("decode") if record else nullcontext():
                decoded.append(self.decode(w))
            if record and n % self.traffic["decode_every"] == self.kept_offset:
                self.kept[n] = (decoded[-1][1], decoded[-1][2])
        outcomes = [(list(numbers), self._verify(decoded, record))]
        if outcomes[0][1][0] != "valid" and len(numbers) > 1:  # which block was refused: each again alone
            outcomes += [([n], self._verify([d], record)) for n, d in zip(numbers, decoded)]
        if record:
            self.outcomes += outcomes
            self.counts["calls"] += 1
            self.counts["blocks"] = self.counts.get("blocks", 0) + len(numbers)
            self.counts["commitments"] += sum(len(st.commitments) for _, sts, _ in decoded for st in sts)
            self.least_s += sum(work_model.verify_block_s(self.config, [len(st.commitments) for st in sts])
                                for _, sts, _ in decoded)

    def step(self) -> None:
        n = self.counts["calls"]
        self._call(range(n * self.per_call, (n + 1) * self.per_call), inputs.BLOCK)

    def _verify(self, blocks, record: bool):
        with self.spans("verify_call") if record else nullcontext():
            return self.run_verify(blocks)

    def pipelined(self, blocks) -> None:
        """One call into the port: the blocks' verdict, or its error."""
        self.bp.RangeProof.verify_batches_pipelined(blocks, self.bp.VerifyAction[self.traffic["action"]],
                                                    device=self.device)

    def run_verify(self, blocks):
        """The call's outcome: ("valid",) or ("error", class, message) of
        its first refused block."""
        try:
            self.pipelined(blocks)
        except self.bp.ProofError as exc:
            return ("error", type(exc).__name__, str(exc))
        return ("valid",)


class ProveCalls(Entry):
    def setup(self) -> None:
        self.made = []  # per call: (commitment encodings per output, proof bytes per output)
        for n in range(2):
            self._call(n, inputs.WARM, record=False)

    def _call(self, number: int, key: int, record: bool = True) -> None:
        outs = inputs.call_outputs(self.seed, self.traffic, self.config, number, key)
        seeded = self.traffic.get("seed_nonce", False)
        with self.spans("commit") if record else nullcontext():
            statements, witnesses = self.statements(outs, seeded)
        with self.spans("prove_call") if record else nullcontext():
            proofs = self.prove(statements, witnesses, StreamRng(self.seed, number if record else -number - 1))
        with self.spans("encode") if record else nullcontext():
            wire = [p.to_bytes() for p in proofs]
        if record:
            self.made.append(([list(st.commitments_compressed) for st in statements], wire))
            self.counts["calls"] += 1
            self.counts["commitments"] += sum(len(st.commitments) for st in statements)
            self.least_s += work_model.prove_call_s(self.config, len(outs), self.traffic["m"])

    def step(self) -> None:
        self._call(self.counts["calls"], inputs.CALL)


ENTRIES = {"verify_stream": VerifyStream, "prove_calls": ProveCalls}
