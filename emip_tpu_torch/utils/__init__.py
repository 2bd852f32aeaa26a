"""Host utilities of the port: logging, flow visualisation, overlays."""
