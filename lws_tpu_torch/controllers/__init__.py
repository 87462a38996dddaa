"""L3 controllers: level-triggered reconcilers over the Store.

- groupset_controller: materializes ordered pods from GroupSets — the role the
  kube statefulset-controller plays for the reference; native here.
- lws_controller: ≈ pkg/controllers/leaderworkerset_controller.go.
- pod_controller: ≈ pkg/controllers/pod_controller.go.
- disagg/: DisaggregatedSet planner/executor/managers.

The port's copy of lws_tpu/controllers/__init__.py.
"""
