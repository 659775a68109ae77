"""The harness's shared parts: input content, traffic, trace reading,
statistics and the roofline arithmetic."""
