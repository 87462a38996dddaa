"""The port's copies of the jax-free `lws_tpu/core/` modules it needs."""
