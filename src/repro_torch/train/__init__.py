"""The port's train / prefill / serve step factories."""
