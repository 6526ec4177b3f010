"""Probes that time one kernel of the port beside what it replaces."""
