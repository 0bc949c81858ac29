"""Federated server loop, communication accounting and algorithm plugins
of the port."""
