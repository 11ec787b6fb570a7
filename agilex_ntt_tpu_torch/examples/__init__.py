"""Runnable examples of the port, one per script of the JAX package's
``examples/``, each with the same sizes, parameters and exact checks:

    python -m agilex_ntt_tpu_torch.examples.<name> [--device cpu|cuda]

Each runs on the card unless ``--device cpu`` is given, and exits non-zero
when a check fails.  ``main(argv)`` runs one from Python.
"""

NAMES = ("rlwe_toy", "basic_usage", "keyswitch_pipeline",
         "production_rns_serving", "ckks_scheme", "bgv_exact", "bfv_exact",
         "poly_activation", "bsgs_matvec", "ckks_rns_toy")
