"""Launchers of the port: ``serve`` (batched prefill and greedy decode on
one card)."""
