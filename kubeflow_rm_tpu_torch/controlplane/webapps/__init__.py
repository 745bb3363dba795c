"""Web front ends of the port (counterpart of
``kubeflow_rm_tpu/controlplane/webapps``): :mod:`.serving`, the
multi-tenant serving gateway over the continuous-batching engine."""
