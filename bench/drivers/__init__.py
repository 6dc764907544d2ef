"""One module per kind of round a traffic mix drives: how the port's
runtime is set up and recorded, and how its checked rounds are judged.
A traffic file names its driver."""
