"""Models of the port: ConvNeXt trunk, PAFPN, unified head, Unicorn."""
