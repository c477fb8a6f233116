"""One driver a kind of traffic, chosen by the traffic file's ``driver``."""
