"""The port's optimizer and learning-rate schedules."""
