"""Prover, verifier, commitments, wire format and session of the port."""
