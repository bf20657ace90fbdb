"""CLI entry points (ref: cmd/ — cobra commands; argparse here)."""
