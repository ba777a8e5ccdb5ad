"""CPU tests of the benchmark (and its controls on the card, `cuda` marker)."""
