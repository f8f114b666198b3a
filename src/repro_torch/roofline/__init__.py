"""Roofline constants of the port's device (``hw``)."""
