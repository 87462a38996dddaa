"""The port's observability and decision planes (counterpart of lws_tpu/obs):
the device plane, the history ring and its signals, request journeys, the
scale recommender, the rollout ledger and canary analyzer, and the decision
ledger with its actuators."""
