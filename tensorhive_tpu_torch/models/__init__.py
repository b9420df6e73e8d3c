"""Model definitions of the port (``tensorhive_tpu/models``)."""
