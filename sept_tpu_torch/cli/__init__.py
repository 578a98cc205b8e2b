"""Fold entry points of the port (the argument parsers come with the CLIs,
ROADMAP.md §1 item 9)."""
