"""The port's training data pipeline (numpy only)."""
