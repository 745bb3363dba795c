"""The port's side of the control plane's seams (counterpart of the parts
of ``kubeflow_rm_tpu/controlplane`` that import the JAX compute path).

The control plane itself (apiserver, controllers, scheduler, the SLO
engine and its time series) is plain Python and is not ported; these
modules are what it calls into the compute path through, each beside
the JAX file of the same path and name:

- :mod:`.webhook.admission_pricer` — prices a declared workload at
  admission with ``analysis.torchcheck.pricer`` against a card slice of
  :mod:`.api.gpu`;
- :mod:`.obs.slo` — bridges ``torchcheck``'s host-sync probe and
  recompile sentinel into per-tenant counters;
- :mod:`.metrics` — those counters and the pricer's, in the JAX
  control plane's series names, on the standard library alone.

They import ``torch``, numpy and the standard library only, and take
the API server by duck typing (``register_admission``,
``record_event``).
"""
