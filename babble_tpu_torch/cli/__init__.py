"""Command-line interface (reference: cmd/babble/)."""
