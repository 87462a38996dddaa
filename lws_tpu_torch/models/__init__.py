"""Model code of the port (counterpart of lws_tpu/models)."""
