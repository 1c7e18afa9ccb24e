"""The benchmark of bulletproofs_plus_tpu_torch on one H100: see run.py."""
