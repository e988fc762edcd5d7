"""One module a kind of traffic; ``traffic/<name>.json`` names its driver."""
