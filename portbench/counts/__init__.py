"""Operation and byte counts: per kernel and per configuration."""
