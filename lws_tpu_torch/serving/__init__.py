"""Serving engines of the port (counterpart of lws_tpu/serving)."""
