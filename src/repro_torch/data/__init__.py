"""The deterministic synthetic data pipeline."""
