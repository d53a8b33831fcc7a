"""Scale-out of the port: Baum-Welch training over local shards (``mesh``)."""
