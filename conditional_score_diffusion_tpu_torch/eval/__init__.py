"""The --mode test harness, its metrics and the offline evaluation pipeline."""
