"""Step builders of the port's LM (serving steps only so far)."""
