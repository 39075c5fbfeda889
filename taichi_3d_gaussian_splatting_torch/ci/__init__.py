"""The experiment gate (``run_experiment``)."""
