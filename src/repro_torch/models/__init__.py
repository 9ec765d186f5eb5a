"""The dense GQA decoder stack of the port: building blocks
(:mod:`.layers`) and model assembly with prefill and decode (:mod:`.model`).
"""
