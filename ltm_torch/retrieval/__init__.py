"""Scan Context loop retrieval (port of ``ltm.retrieval``)."""
