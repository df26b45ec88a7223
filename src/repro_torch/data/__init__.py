"""The port's copy of the reference's synthetic data pipeline."""
