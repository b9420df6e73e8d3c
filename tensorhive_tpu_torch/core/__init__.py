"""Service layer of the port (``tensorhive_tpu/core``)."""
