"""Host-side helpers of the port (copies of jax-free modules of
``tensorhive_tpu/utils/``)."""
