"""The benchmark harness of pseudoaligner_torch's device mapping step.

`run.py` is the entry; the modules here are driven by the files named in
BENCHMARK.json: a configuration file under configs/, a traffic file under
traffic/ and one reader per metric under metrics/.  Nothing here imports
jax, jaxlib or pseudoaligner_tpu; the plain reference lives in
reference/ and imports nothing of pseudoaligner_torch.
"""
