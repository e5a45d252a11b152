"""The port's evaluation entry points (counterparts of the repository's `scripts/`)."""
