"""Evaluation of the port: metrics, the sliding-window vote and the
utility-privacy sweep."""
