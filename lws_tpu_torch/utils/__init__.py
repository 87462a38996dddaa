"""The port's copies of the jax-free `lws_tpu/utils/` helpers it needs."""
