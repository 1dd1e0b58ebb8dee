"""Native (C++) host components: the PNG decoder, built at first use."""
