"""Deployment path: everything that takes the port's control plane out
of the in-memory test harness and onto a real cluster (the port's copy
of ``kubeflow_rm_tpu/controlplane/deploy``).

The reference deploys via kubebuilder-generated CRDs
(``notebook-controller/config/crd/bases/``), kustomize overlays
(``config/overlays/``), controller processes (``main.go``) and an HTTPS
admission server (``admission-webhook/main.go:755-773``). This package
is the GPU build's equivalent:

- ``crds``            — CRD manifests generated from the SAME api/*.py
                        validators the in-memory apiserver enforces
- ``kubeclient``      — the ``APIServer`` verb surface implemented
                        against a real kube-apiserver over REST, so the
                        SAME controllers/webhooks run in-cluster; its
                        ``ShardedKubeAPIServer`` routes over N shards
- ``restserver``      — the kube REST surface over an in-memory
                        ``APIServer`` (a cluster without a cluster)
- ``webhook_server``  — HTTPS AdmissionReview v1 server wrapping the
                        three webhook classes (the last the card-slice
                        injector), and the CRDs' ``/convert`` endpoint
- ``manifests``       — kustomize tree renderer
"""
