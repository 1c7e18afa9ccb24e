"""Host Fiat-Shamir layer: Keccak, STROBE, Merlin, hashing."""
