"""Examples (port of ``bigdl_tpu/example``: ``gpt2_import``)."""
