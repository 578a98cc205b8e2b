"""Data staging, on-device ingest and corpus featurization of the port."""
