"""Roofline arithmetic of the port, under the H100 SXM5's published peaks."""
