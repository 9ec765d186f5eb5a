"""Serving pieces of the port: request retry and the prefill/decode step
builders (:mod:`.server`)."""
