"""What the distributed layer holds on one device: gradient compression."""
