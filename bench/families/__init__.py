"""One module per model family: how a configuration of that family is made
(data, weights) and handed to the port, and which plain reference judges
it.  A configuration's JSON names its family."""
