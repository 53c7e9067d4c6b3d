"""Graph IO and training datasets (numpy)."""
