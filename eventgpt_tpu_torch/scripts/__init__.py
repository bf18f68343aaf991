"""Command-line studies of the port: Medusa-head training
(``train_medusa``) and the trained-draft acceptance study
(``medusa_acceptance``), ports of the JAX package's ``scripts/``."""
