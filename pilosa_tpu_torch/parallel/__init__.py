"""Distribution layer (L5). The port has its hashing so far; the device
mesh and the cluster come with the multi-device plane (ROADMAP A8)."""
