"""The port's copies of the control plane's API vocabulary that its
seams call: object helpers (:mod:`.meta`), the card slice table
(:mod:`.gpu`), and the Notebook and TPUJob fields the admission pricer
and the launcher read (:mod:`.notebook`, :mod:`.tpujob`)."""
