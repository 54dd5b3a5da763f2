"""The model stack the LM-loss workload evaluates (copies of the parts of
``repro/models`` that h2o-danube-3 and rwkv6 run)."""
