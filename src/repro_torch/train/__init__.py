"""Step builders and the fault-tolerant training loop of the port's LM."""
