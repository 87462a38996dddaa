"""The port's device-runtime observability (counterpart of lws_tpu/obs)."""
