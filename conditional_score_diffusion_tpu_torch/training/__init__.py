"""Training schedules (the VS-CMDE sigma_y anneal)."""
