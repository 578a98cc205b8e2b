"""Drivers, one per kind of traffic: ``drivers/<kind>.py`` runs the cells
whose traffic file names that ``kind``."""
