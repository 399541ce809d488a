"""Device placement (mesh.py: a batch split over a list of devices) and
host-side quorum parallelism (quorum.py: thread-pool fan-out with
write/read quorum semantics)."""
