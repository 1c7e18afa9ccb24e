"""The benchmark's plain reference: Bulletproofs+ range proofs over
ristretto255 in exact Python integers and numpy (Merlin transcripts on a
numpy Keccak-f[1600]), a frozen copy of the host oracle of
bulletproofs_plus_tpu_torch (its sequential prover, host verifier engine,
codec and generators) that imports nothing of the port, of torch or of JAX.
The comparison that decides a run's `correct` holds the port's outputs
against it.

Frozen from the port as of commit 1b057bba26133a0f26fdfa32ad21f8e99d389c08
(`ristretto.py`, `strobe.py`, `errors.py` unchanged; the rest cut to the
host paths, without torch).  At that commit the repo's tests hold this code
against the JAX package on the same inputs: tests/test_torch_prover.py
(`test_prove_batch_matches_jax_sequential`, and the golden vectors of the
Rust reference in `test_prove_with_rng_reproduces_golden`),
tests/test_torch_host_engine.py (`test_host_engine_mixed_batch_matches_jax`,
`test_host_engine_errors_match_jax`, `test_serde_hooks_match_jax`),
tests/test_torch_verify.py (`test_verify_matches_jax_host`) and
tests/test_torch_ristretto.py (`test_decompress_plain_matches_jax_and_host`).

Against the device paths (R1, S1, D1, the MSMs, the batched prover's
kernels) it is an independent second reading.  The decode and the wallet's
commitments run on the port's host code, of which this is a copy: there the
comparison is a guard against the port's host code changing, not an
independent reference.
"""
