"""Launchers of the port: the train, prefill and decode steps, the
training CLI and the serving CLI."""
